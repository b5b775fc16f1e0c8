"""Test only: the window's steps, a metric added as a file of its own."""


def read(ctx):
    return ctx["steps"]
