"""tables_mib: device memory that load_scene leaves allocated (the
scene's tables), in MiB."""


def read(w):
    return None if w.tables_bytes is None else w.tables_bytes / 2 ** 20
