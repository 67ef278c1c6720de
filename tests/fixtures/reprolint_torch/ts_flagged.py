"""Flagged fixture: TS401 fires on both json serialization entry points."""
import json


def emit(rec):
    return json.dumps(rec)  # TS401


def emit_to(rec, fh):
    json.dump(rec, fh)  # TS401
