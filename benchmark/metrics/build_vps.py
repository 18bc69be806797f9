"""build_vps: rows indexed over the build's wall time, from the inputs on
the device to a searchable index, ending in a synchronise (host clock)."""


def read(run):
    return run.build_rows / run.build_s
