"""Suppression fixture: an allow without the mandatory reason — expect
RPL001 *and* the undimmed TS401."""
import json


def emit(rec):
    return json.dumps(rec)  # reprolint: allow[TS401]
