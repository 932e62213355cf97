"""Median over the window's frames of the time from the client sending a
request to the server starting its frame: the request's wait in the viewer's
poll loop (`viewer.handle_viewer_request`)."""


def read(ctx):
    return ctx.info.get("poll_ms")
