"""build_s: seconds of the port's load_scene (ingest, tree build and the
tables' upload), host clock from a synchronize to a synchronize."""


def read(w):
    return w.build_s
