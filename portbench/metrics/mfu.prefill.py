"""``mfu.prefill``: the prefills' model operations over the traced window's
length, as a share of the card's peak (``counts.prefill_flops``: every
product of the forward, attention's causal pairs, the last position's
unembedding). Reads nothing in a cell that is not a prefill."""
from portbench import counts


def read(run: dict):
    mix, config = run["mix"], run["config"]
    if mix["kind"] != "prefill":
        return None
    flops = counts.prefill_flops(run["arch"], config, mix["batch"], mix["seq_len"]) * run["items"]
    return 100.0 * flops / run["window_s"] / counts.PEAK_FLOPS[counts.dtype(config)]
