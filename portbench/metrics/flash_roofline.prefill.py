"""``flash_roofline.prefill``: the attention kernels' share of their
roofline in the traced prefills: the least time the configuration's causal
attention calls could take (``counts.attention_bound_s``, one call a
layer in each of the window's batches) over the device time of the operations whose names match
``PATTERNS``. The patterns cover the port's bf16 flash kernel and the names
of PyTorch's and the CUDA libraries' attention kernels, so that a kernel put
in its place is still read. Reads nothing where no operation matches."""
from portbench import counts

PATTERNS = ("flash_attention", "flash_fwd", "fmha", "attention_kernel", "sdpa", "attn_fwd",
            "scaled_dot_product")


def read(run: dict):
    mix, config, trace = run["mix"], run["config"], run["trace"]
    if mix["kind"] != "prefill":
        return None
    busy = sum(s for name, s in trace["by_name"].items()
               if any(p in name.lower() for p in PATTERNS))
    if busy <= 0.0:
        return None
    arch = run["arch"]
    bound = counts.attention_bound_s(arch, config, mix["batch"], mix["seq_len"])
    return 100.0 * bound * counts.attention_layers(arch, config) * run["items"] / busy
