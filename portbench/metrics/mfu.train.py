"""``mfu.train``: the training steps' model operations (forward and
backward, three forwards; remat's recomputation not counted) over the traced
window's length, as a share of the card's peak. Reads nothing in a cell that
does not train."""
from portbench import counts


def read(run: dict):
    mix, config = run["mix"], run["config"]
    if mix["kind"] != "train":
        return None
    flops = counts.train_step_flops(run["arch"], config, mix["batch"], mix["seq_len"]) * run["items"]
    return 100.0 * flops / run["window_s"] / counts.PEAK_FLOPS[counts.dtype(config)]
