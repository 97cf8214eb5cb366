"""The whole window over the frames completed in it (host clock)."""


def read(window):
    return 1e3 * window["seconds"] / window["units"]
