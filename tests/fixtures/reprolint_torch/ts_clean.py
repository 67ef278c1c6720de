"""Clean fixture: serialization through the sanctioned door — zero TS
findings. (Never imported; the import line is just realistic syntax.)"""
from repro_torch.obs.trace import dumps_strict


def emit(rec):
    return dumps_strict(rec)


def emit_to(rec, fh):
    fh.write(dumps_strict(rec) + "\n")
