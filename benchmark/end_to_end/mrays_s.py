"""Millions of rays traced a second: every ray of the window's steps over the
window's length."""


def read(window):
    return window.work / window.seconds / 1e6
