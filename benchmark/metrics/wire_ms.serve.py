"""Median over the window's frames of the time from the server starting to
send a frame (`ViewerServer.send_image`) to its last byte at the client: the
frame's copy to the socket and its trip over loopback."""


def read(ctx):
    return ctx.info.get("wire_ms")
