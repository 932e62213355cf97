"""The training photos on the device, each once at its own size in 8 bits, and
each step's padded float32 view built from them.

Every photo and mask is decoded from an 8-bit file, and the readers divide by
255 in float32. So the store keeps the bytes: each photo's RGB (RGBA for a
Blender frame with alpha) and its sky and occluder masks as uint8 at the
photo's own size, in one device buffer, at most 5 bytes a photo pixel (a mask
the camera lacks takes none). The photos are decoded on a thread pool
(`readers.decode_each`) and each is copied to the device as it comes, so the
host holds a bounded number of them at once and no float32 copy of the
collection is made.

`fetch(i)` builds view i's canvas into buffers reused from step to step,
inside the profiler range "trainer.view_fetch": the image over 255 and the
two masks over 255 inside the photo; outside it the image and the sky mask
are 0 and so is the occluder mask, so padding drops out of every masked loss.
That is `trainer.pad_cameras`'s canvas, bit for bit. On the card one launch
of kernel V (`ops/cuda/view_unpack.py`) builds it; on the CPU its plain
version `unpack_view_plain`. `stats()` gives the store's counters.
"""

from __future__ import annotations

import os

import torch

from ..ops.cuda.view_unpack import unpack_view
from .readers import UNIT, decode_each

_UNIT = torch.from_numpy(UNIT)   # the readers' arithmetic: a byte over 255 in float32


def unpack_view_plain(rgb: torch.Tensor, sky: torch.Tensor | None, occ: torch.Tensor | None,
                      background: float | None, out: tuple):
    """The plain version of kernel V: `ops/cuda/view_unpack.unpack_view`'s
    canvas, written into out = (image, sky mask, occluder mask)."""
    image, sky_out, occ_out = out
    h, w = rgb.shape[:2]
    unit = _UNIT.to(rgb.device)
    f = unit[rgb.long()]
    if background is not None:
        f = f[..., :3] * f[..., 3:4] + background * (1 - f[..., 3:4])
    for o in out:
        o.zero_()
    image[:h, :w] = f
    sky_out[:h, :w] = 1.0 if sky is None else unit[sky.long()]
    occ_out[:h, :w] = 1.0 if occ is None else unit[occ.long()]
    return out


class ViewStore:
    """The training cameras' photos on `device`, on an H x W canvas.

    `cams[i]`, `mats[i]` (its `CameraMatrices` on the device), `fetch(i,
    slot)` -> (image [H, W, 3], sky mask [H, W], occluder mask [H, W]) in the
    slot's reused buffers; `view(i)` or `store[i]` -> a padded view dict with
    canvases of its own (`cam`, `mats`, `image_t`, `sky_t`, `occ_t` and the
    host arrays `image`, `sky_mask`, `occluders_mask`)."""

    def __init__(self, cameras: list, H: int, W: int, device):
        self.cams, self.H, self.W = list(cameras), H, W
        self.device = torch.device(device)
        self.mats = [c.matrices(self.device) for c in self.cams]
        self.fetches = self.fetch_photo_pixels = self.fetch_canvas_pixels = 0
        self._slots = {}
        # Each photo's bytes in the buffer: [h, w, C] image, then the masks
        # it has, [h, w] each. The buffer is sized from the headers and the
        # mask files that exist: C = 3, or 4 for a Blender frame (which may
        # have alpha, and has no masks).
        if any(c.source is None for c in self.cams):
            raise ValueError("the view store takes the cameras a reader made (with a source)")
        size = sum(c.width * c.height * ((4 if c.source.background is not None else 3)
                                         + sum(bool(p) and os.path.exists(p) for p in (
                                             c.source.sky_mask_path,
                                             c.source.occluders_mask_path)))
                   for c in self.cams)
        self.buffer = torch.empty(size, dtype=torch.uint8, device=self.device)
        decode = lambda c: (c.source.image_u8(), c.source.mask_u8("sky_mask"),
                            c.source.mask_u8("occluders_mask"))
        self._parts, at = [], 0
        for cam, arrays in zip(self.cams, decode_each(self.cams, decode)):
            if arrays[0].shape[:2] != (cam.height, cam.width):
                raise ValueError(f"{cam.image_name}: {arrays[0].shape[:2]} pixels, "
                                 f"{(cam.height, cam.width)} expected")
            views = []
            for a in arrays:
                if a is None:
                    views.append(None)
                    continue
                views.append(self.buffer[at:at + a.size].view(a.shape))
                views[-1].copy_(torch.from_numpy(a))
                at += a.size
            rgba = arrays[0].shape[-1] == 4
            self._parts.append((*views, cam.source.background if rgba else None))

    def __len__(self) -> int:
        return len(self.cams)

    def _canvas(self):
        H, W, dev = self.H, self.W, self.device
        return (torch.empty((H, W, 3), dtype=torch.float32, device=dev),
                torch.empty((H, W), dtype=torch.float32, device=dev),
                torch.empty((H, W), dtype=torch.float32, device=dev))

    def fetch(self, i: int, slot: int = 0):
        """View i's canvas (image, sky mask, occluder mask) in slot `slot`'s
        buffers, which the next fetch into that slot overwrites."""
        with torch.profiler.record_function("trainer.view_fetch"):
            if slot not in self._slots:
                self._slots[slot] = self._canvas()
            out = unpack_view(*self._parts[i], self._slots[slot])
        self.fetches += 1
        self.fetch_photo_pixels += self.cams[i].width * self.cams[i].height
        self.fetch_canvas_pixels += self.H * self.W
        return out

    def view(self, i: int) -> dict:
        cam = self.cams[i]
        image, sky, occ = unpack_view(*self._parts[i], self._canvas())
        host = lambda t: t.cpu().numpy()
        return dict(cam=cam, mats=self.mats[i], image_t=image, sky_t=sky, occ_t=occ,
                    image=host(image), sky_mask=host(sky), occluders_mask=host(occ))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self.view(j) for j in range(len(self))[i]]
        return self.view(i)

    def stats(self) -> dict:
        """The store's device bytes, photos and their pixels; the fetches so
        far, and the photo pixels and canvas pixels they covered."""
        return {"device_bytes": self.buffer.numel(), "photos": len(self.cams),
                "pixels": sum(c.width * c.height for c in self.cams),
                "fetches": self.fetches, "fetch_photo_pixels": self.fetch_photo_pixels,
                "fetch_canvas_pixels": self.fetch_canvas_pixels}
