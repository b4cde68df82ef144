"""Millions of visibilities flagged by the calls of the window (each
waits for its flags on the card), over the window's seconds."""


def read(ctx):
    return ctx.window.rate("vis") / 1e6
