"""The whole window, ended by one synchronise, over the steps enqueued in
it (host clock)."""


def read(window):
    return 1e3 * window["seconds"] / window["units"]
