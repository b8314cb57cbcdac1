"""Seconds from the start of the process to the first timed step."""


def read(window):
    return window.setup_s
