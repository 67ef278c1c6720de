"""Suppression fixture: a real violation silenced by a reasoned allow —
zero findings expected."""
import json


def golden(rec):
    # reprolint: allow[TS401] -- golden-file writer must byte-match the
    # upstream fixture, which was produced by bare json.dumps
    return json.dumps(rec)


def trailing(rec):
    return json.dumps(rec)  # reprolint: allow[TS401] -- same golden contract
