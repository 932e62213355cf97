"""The viewer client of the "serve" traffic kind, run as its own process:

    python3 -m benchmark.client PLAN.json RESULT.json

PLAN holds the server's port, one period of requests (json protocol of the
port's `viewer.ViewerServer`), the window's start and length, the frame size
and which frames to keep. The client is one viewer in a closed loop: from the
window's start it sends a request, reads its frame to the last byte, and
sends the next (cycling over the period) until the window's length has
passed; a request is never sent after that. It writes when each request was
sent and answered (perf_counter seconds, a clock shared by the processes of
one host), and the kept frames as .npy: the first frame sent at or after
each of `keep_after_s` seconds into the window, and the frames whose numbers
are in `keep_index`. Nothing but the socket library and numpy is imported.
"""

from __future__ import annotations

import json
import socket
import struct
import sys
import time

import numpy as np

TIMEOUT_S = 120.0


def recv_into(sock: socket.socket, view: memoryview):
    got = 0
    while got < len(view):
        n = sock.recv_into(view[got:])
        if n == 0:
            raise ConnectionError("server closed")
        got += n


def main(argv) -> int:
    plan_path, out_path = argv
    with open(plan_path) as f:
        plan = json.load(f)
    reqs = plan["requests"]
    frame_bytes = plan["width"] * plan["height"] * 3
    keep_after = sorted(plan["keep_after_s"])
    keep_index = set(plan["keep_index"])
    payloads = []
    for r in reqs:
        body = json.dumps(r).encode()
        payloads.append(struct.pack("<I", len(body)) + body)

    sock = socket.create_connection(("127.0.0.1", plan["port"]), timeout=TIMEOUT_S)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    t0 = time.perf_counter() + plan["lead_s"]
    t_close = t0 + plan["seconds"]
    time.sleep(max(t0 - time.perf_counter(), 0.0))
    sent, done, kept, errors = [], [], {}, []
    buf = bytearray(frame_bytes)
    view = memoryview(buf)
    head = bytearray(4)
    try:
        i = 0
        while (now := time.perf_counter()) < t_close:
            keep = i in keep_index
            while keep_after and now - t0 >= keep_after[0]:
                keep_after.pop(0)
                keep = True
            sent.append(now)
            sock.sendall(payloads[i % len(payloads)])
            recv_into(sock, memoryview(head))
            (ln,) = struct.unpack("<I", head)
            if ln != frame_bytes:
                raise ValueError(f"frame {i}: {ln} bytes, want {frame_bytes}")
            recv_into(sock, view)
            done.append(time.perf_counter())
            if keep:
                kept[i] = bytes(buf)
            i += 1
    except (OSError, ValueError) as exc:
        errors.append(f"frame {len(done)}: {exc!r}")
    sock.close()
    for i, data in kept.items():
        np.save(f"{plan['frames_dir']}/frame_{i}.npy",
                np.frombuffer(data, np.uint8).reshape(plan["height"], plan["width"], 3))
    with open(out_path, "w") as f:
        json.dump({"t0": t0, "sent": sent, "done": done, "errors": errors,
                   "kept": sorted(kept)}, f)
    return 0 if not errors else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
