"""Milliseconds a build: the window's length over the builds completed in it."""


def read(window):
    return 1e3 * window.seconds / window.steps
