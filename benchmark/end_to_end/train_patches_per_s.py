"""Patches whose train step finished in the window, over the window's
seconds (the window closes on a synchronisation, so every step launched
in it has finished)."""


def read(ctx):
    return ctx.window.rate("patches")
