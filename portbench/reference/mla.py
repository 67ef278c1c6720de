"""Plain float32 reference of the MLA decoders the benchmark runs, and what
the harness needs to know of the architecture: the port's configuration
fields it is held to, and the operations its layers count.

A configuration file names its architecture's module under ``reference``
(``"reference": "mla"``); the harness loads ``reference/<name>.py`` by that
name. Such a module gives ``PORT_FIELDS``, ``port_mismatches``,
``spec_from_config``, ``layer_kinds``, ``attention_shape``, ``token_flops``,
``all_weights``, ``decayed``, ``forward`` and ``prefill_logits``, and
imports only torch and the reference's own helpers.

The architecture is read from a configuration's own keys (Hugging Face
names: ``hidden_size``, ``qk_nope_head_dim``, ``n_routed_experts`` ...):
multi-head latent attention (DeepSeek-V2 Sec. 2.1, with or without the q
LoRA), a SwiGLU MLP in the first ``first_k_dense_replace`` layers (every
layer of a model without experts) and a mixture of experts in the rest:
shared experts plus the top-k of a softmax router over the routed experts,
each expert taking at most ``capacity`` tokens of a sequence. Every product,
norm and softmax is float32 (TF32 off); the weights are the stored values,
upcast.

Departures from the published models, as the measured program runs them:
RoPE rotates the two halves of the rope dims (the published code permutes
interleaved pairs into that layout, a fixed permutation of weight columns);
the configuration's ``departs`` lists the rest (no YaRN or LongRoPE scaling,
no MiniCPM embedding, depth or logit scalings, the routed gates renormalised
over the top k, the balance loss over the whole batch). A token's choices
past an expert's capacity are dropped, the choices ranked first by choice (a
token's first choices before any second choice) and then by position.

The weights are drawn again from the seed, in the order and by the rule the
program draws them (a truncated normal at +-2 sigma in float32, scaled by
``fan_in ** -0.5``, 1 for the embeddings, rounded to the stored dtype; norm
scales start at one and the router is stored in float32).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference.lowp import Arith

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Spec:
    d: int
    vocab: int
    heads: int
    nope: int
    rope: int
    v: int
    q_lora: int
    kv_lora: int
    d_ff: int
    layers: int
    dense_layers: int  # leading layers with a dense MLP
    experts: int
    shared: int
    top_k: int
    moe_ff: int
    capacity_factor: float
    eps: float
    theta: float
    norm_topk: bool

    @property
    def qk(self) -> int:
        return self.nope + self.rope


def spec_from_config(c: dict) -> Spec:
    """The reference's architecture from a configuration file's keys."""
    if c.get("tie_word_embeddings"):
        raise ValueError("the reference unembeds with a table of its own")
    experts = c.get("n_routed_experts") or 0
    layers = c["num_hidden_layers"]
    return Spec(
        d=c["hidden_size"], vocab=c["vocab_size"], heads=c["num_attention_heads"],
        nope=c["qk_nope_head_dim"], rope=c["qk_rope_head_dim"], v=c["v_head_dim"],
        q_lora=c.get("q_lora_rank") or 0, kv_lora=c["kv_lora_rank"],
        d_ff=c["intermediate_size"], layers=layers,
        dense_layers=c.get("first_k_dense_replace", 0) if experts else layers,
        experts=experts, shared=c.get("n_shared_experts") or 0,
        top_k=c.get("num_experts_per_tok") or 0, moe_ff=c.get("moe_intermediate_size") or 0,
        capacity_factor=float(c.get("capacity_factor", 1.25)), eps=float(c["rms_norm_eps"]),
        theta=float(c["rope_theta"]), norm_topk=bool(c.get("norm_topk_prob", False)),
    )


# configuration key -> the port's ModelConfig field, besides the harness's
# common ones
PORT_FIELDS = {
    "qk_nope_head_dim": "head_dim", "qk_rope_head_dim": "qk_rope_head_dim",
    "v_head_dim": "v_head_dim", "q_lora_rank": "q_lora_rank", "kv_lora_rank": "kv_lora_rank",
    "moe_intermediate_size": "moe_d_ff", "n_routed_experts": "n_experts",
    "n_shared_experts": "n_shared_experts", "num_experts_per_tok": "top_k",
    "capacity_factor": "capacity_factor",
}


def layer_kinds(c: dict) -> list[str]:
    """``dense`` or ``moe``, layer by layer."""
    n = c["num_hidden_layers"]
    if not c.get("n_routed_experts"):
        return ["dense"] * n
    first = c.get("first_k_dense_replace", 0)
    return ["dense" if i < first else "moe" for i in range(n)]


def port_mismatches(c: dict, cfg) -> list[str]:
    """Where the port's configuration ``cfg`` is not the architecture the
    configuration ``c`` (as run) describes."""
    wrong = []
    if [(b.mixer, b.mlp) for b in cfg.blocks] != [("mla", k) for k in layer_kinds(c)]:
        wrong.append("the port's blocks are not the file's MLA layers, dense then MoE")
    if c.get("n_routed_experts") and not c.get("norm_topk_prob"):
        wrong.append("the port renormalises the routed gates: norm_topk_prob must be true")
    if c.get("hidden_act", "silu") != "silu" or not cfg.mlp_gated:
        wrong.append("the port's MLPs are SwiGLU")
    return wrong


# ---------------------------------------------------------------------------
# Operations, from the shapes alone (counts.py's per-architecture part)
# ---------------------------------------------------------------------------
def attention_shape(c: dict) -> tuple[int, int, int]:
    """(heads, q and k head dim, v head dim) of an attention layer."""
    return (c["num_attention_heads"], c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
            c["v_head_dim"])


def token_flops(c: dict) -> dict[str, int]:
    """Operations a token needs in each layer kind's products (attention's
    score and value products apart), and in the unembedding. The experts
    count the top-k routed experts and the shared ones, not the capacity's
    padding."""
    d, (H, Dk, Dv) = c["hidden_size"], attention_shape(c)
    r, dn = c["kv_lora_rank"], c["qk_nope_head_dim"]
    ql = c.get("q_lora_rank") or 0
    mixer = 2 * (d * ql + ql * H * Dk if ql else d * H * Dk)
    mixer += 2 * d * (r + c["qk_rope_head_dim"]) + 2 * r * H * (dn + Dv) + 2 * H * Dv * d
    out = {"dense": mixer + 2 * 3 * d * c["intermediate_size"],
           "unembed": 2 * d * c["vocab_size"]}
    if c.get("n_routed_experts"):
        f, E = c["moe_intermediate_size"], c["n_routed_experts"]
        experts = c["num_experts_per_tok"] + (c.get("n_shared_experts") or 0)
        out["moe"] = mixer + 2 * d * E + experts * 2 * 3 * d * f
    return out


# ---------------------------------------------------------------------------
# Weights, drawn as the program draws them
# ---------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def _dense(gen, d_in: int, d_out: int, dtype, device) -> Tensor:
    return _normal(gen, (d_in, d_out), d_in**-0.5, dtype, device)


def _ones(n: int, device) -> Tensor:
    return torch.ones((n,), dtype=torch.float32, device=device)


def _mlp(gen, d: int, ff: int, dtype, device) -> dict:
    up = _dense(gen, d, ff, dtype, device)  # drawn up, down, gate
    down = _dense(gen, ff, d, dtype, device)
    return {"up": up, "down": down, "gate": _dense(gen, d, ff, dtype, device)}


def layer_weights(gen, s: Spec, i: int, dtype, device) -> dict:
    """Layer ``i``'s weights, drawn next from ``gen``."""
    p: dict = {"norm1": _ones(s.d, device)}
    m: dict = {}
    if s.q_lora:
        m["q_down"] = _dense(gen, s.d, s.q_lora, dtype, device)
        m["q_norm"] = _ones(s.q_lora, device)
        m["q_up"] = _dense(gen, s.q_lora, s.heads * s.qk, dtype, device)
    else:
        m["wq"] = _dense(gen, s.d, s.heads * s.qk, dtype, device)
    m["kv_down"] = _dense(gen, s.d, s.kv_lora + s.rope, dtype, device)
    m["kv_norm"] = _ones(s.kv_lora, device)
    m["kv_up"] = _dense(gen, s.kv_lora, s.heads * (s.nope + s.v), dtype, device)
    m["wo"] = _dense(gen, s.heads * s.v, s.d, dtype, device)
    p["mixer"] = m
    p["norm2"] = _ones(s.d, device)
    if i < s.dense_layers:
        p["mlp"] = _mlp(gen, s.d, s.d_ff, dtype, device)
    else:
        E, f = s.experts, s.moe_ff
        e: dict = {"router": _normal(gen, (s.d, E), s.d**-0.5, torch.float32, device)}
        e["w_up"] = _normal(gen, (E, s.d, f), s.d**-0.5, dtype, device)
        e["w_down"] = _normal(gen, (E, f, s.d), f**-0.5, dtype, device)
        e["w_gate"] = _normal(gen, (E, s.d, f), s.d**-0.5, dtype, device)
        if s.shared:
            e["shared"] = _mlp(gen, s.d, s.shared * f, dtype, device)
        p["moe"] = e
    return p


def draw(s: Spec, seed: int, device, dtype=torch.bfloat16):
    """The weights in draw order, one part at a time: ``("embed", t)``,
    ``("final_norm", t)``, ``("layer", i, tree)`` for each layer, then
    ``("unembed", t)``. A caller can use each part and drop it before the
    next is drawn."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    yield ("embed", _normal(gen, (s.vocab, s.d), 1.0, dtype, device))
    yield ("final_norm", _ones(s.d, device))
    for i in range(s.layers):
        yield ("layer", i, layer_weights(gen, s, i, dtype, device))
    yield ("unembed", _normal(gen, (s.vocab, s.d), 1.0, dtype, device))


def leaves(tree: dict, prefix: str = "") -> list[tuple[str, Tensor]]:
    """(name, tensor) of a nested dict, names joined with ``/``."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out += leaves(v, name) if isinstance(v, dict) else [(name, v)]
    return out


def all_weights(s: Spec, seed: int, device, dtype=torch.bfloat16) -> dict[str, Tensor]:
    """Every weight by name: ``embed``, ``final_norm``, ``unembed`` and
    ``layers/<i>/...``."""
    out: dict[str, Tensor] = {}
    for part in draw(s, seed, device, dtype):
        if part[0] == "layer":
            out.update(leaves(part[2], f"layers/{part[1]}"))
        else:
            out[part[0]] = part[1]
    return out


def layer_tree(flat: dict[str, Tensor], i: int) -> dict:
    """Layer ``i``'s nested weights from a flat name map."""
    tree: dict = {}
    head = f"layers/{i}/"
    for name, t in flat.items():
        if name.startswith(head):
            *path, last = name[len(head):].split("/")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[last] = t
    return tree


# ---------------------------------------------------------------------------
# Forward, float32
# ---------------------------------------------------------------------------
def rmsnorm(x: Tensor, g: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g.float()


def rope(x: Tensor, theta: float) -> Tensor:
    """x (B, S, H, D): positions 0..S-1, the two halves of D rotated."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: Tensor, k: Tensor, v: Tensor, scale: float, ar: Arith,
                     block: int = 1024) -> Tensor:
    """softmax(q k^T * scale, causal) v in query blocks; q, k (B, S, H, Dk),
    v (B, S, H, Dv) -> (B, S, H, Dv)."""
    B, S, H, _ = q.shape
    qh = ar.round(q.transpose(1, 2) * scale)
    kh, vh = ar.round(k.transpose(1, 2)), ar.round(v.transpose(1, 2))
    outs = []
    for i0 in range(0, S, block):
        i1 = min(i0 + block, S)
        s = qh[:, :, i0:i1] @ kh[:, :, :i1].transpose(-1, -2)  # (B, H, bq, i1)
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(i1, device=q.device)[None, :] > rows, float("-inf"))
        outs.append(ar.round(torch.softmax(s, dim=-1)) @ vh[:, :, :i1])
        del s
    return torch.cat(outs, dim=2).transpose(1, 2)


def mla(p: dict, s: Spec, x: Tensor, ar: Arith) -> Tensor:
    B, S, _ = x.shape
    if s.q_lora:
        q = ar.mm(rmsnorm(ar.mm(x, p["q_down"]), p["q_norm"], s.eps), p["q_up"])
    else:
        q = ar.mm(x, p["wq"])
    q = q.reshape(B, S, s.heads, s.qk)
    q = torch.cat([q[..., : s.nope], rope(q[..., s.nope:], s.theta)], dim=-1)
    kv = ar.mm(x, p["kv_down"])
    c = rmsnorm(kv[..., : s.kv_lora], p["kv_norm"], s.eps)
    k_pe = rope(kv[..., None, s.kv_lora:], s.theta).expand(B, S, s.heads, s.rope)
    kv_up = ar.mm(c, p["kv_up"]).reshape(B, S, s.heads, s.nope + s.v)
    k = torch.cat([kv_up[..., : s.nope], k_pe], dim=-1)
    o = causal_attention(q, k, kv_up[..., s.nope:], s.qk**-0.5, ar)
    return ar.mm(o.reshape(B, S, s.heads * s.v), p["wo"])


def swiglu(p: dict, x: Tensor, ar: Arith) -> Tensor:
    return ar.mm(F.silu(ar.mm(x, p["gate"])) * ar.mm(x, p["up"]), p["down"])


def capacity(s: Spec, tokens: int) -> int:
    """An expert's slots in one sequence: the capacity factor times its even
    share of the top-k choices, at least 4, rounded up to a multiple of 4."""
    c = math.ceil(tokens * s.top_k / s.experts * s.capacity_factor)
    return max(4, -(-c // 4) * 4)


def moe(p: dict, s: Spec, x: Tensor, ar: Arith) -> tuple[Tensor, dict]:
    """x (G, T, d), each sequence routed on its own; returns (y, aux)."""
    G, T, d = x.shape
    E, k = s.experts, s.top_k
    logits = ar.mm(x, p["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, topi = torch.topk(probs, k, dim=-1)
    if s.norm_topk:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # rank in expert: choices in the order (choice, position)
    order = topi.transpose(1, 2).reshape(G, k * T)
    onehot = F.one_hot(order, E)
    rank = (onehot.cumsum(dim=1) - onehot).gather(2, order[..., None])[..., 0]
    keep = (rank < capacity(s, T)).reshape(G, k, T).transpose(1, 2)  # (G, T, k)
    xf = x.reshape(G * T, d)
    weight = (gates * keep).reshape(G * T, k)
    flat_topi = topi.reshape(G * T, k)
    out = torch.zeros((G * T, d), dtype=torch.float32, device=x.device)
    for e in range(E):
        hit = (flat_topi == e) & keep.reshape(G * T, k)
        rows = hit.any(dim=-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xe = xf[rows]
        h = F.silu(ar.mm(xe, p["w_gate"][e])) * ar.mm(xe, p["w_up"][e])
        w = (weight[rows] * hit[rows]).sum(dim=-1, keepdim=True)
        out = out.index_add(0, rows, ar.mm(h, p["w_down"][e]) * w)
    y = out.reshape(G, T, d)
    if "shared" in p:
        y = y + swiglu(p["shared"], x, ar)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))
    aux = {"moe_balance_loss": E * torch.sum(me * ce),
           "moe_dropped_frac": 1.0 - keep.float().mean(),
           "moe_router_zloss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return y, aux


def layer(p: dict, s: Spec, i: int, x: Tensor, ar: Arith) -> tuple[Tensor, dict]:
    x = x + mla(p["mixer"], s, rmsnorm(x, p["norm1"], s.eps), ar)
    h = rmsnorm(x, p["norm2"], s.eps)
    if i < s.dense_layers:
        return x + swiglu(p["mlp"], h, ar), {}
    y, aux = moe(p["moe"], s, h, ar)
    return x + y, aux


def unembed(table: Tensor, x: Tensor, ar: Arith) -> Tensor:
    return ar.mm(x, table.t())


def decayed(s: Spec, name: str, t: Tensor) -> bool:
    """Whether AdamW decays the leaf: matrices, and the vectors of the
    layers the program stacks (all layers of a model without experts, the
    layers after the leading dense ones of one with experts), since the
    program decays by a leaf's rank."""
    if t.dim() >= 2:
        return True
    parts = name.split("/")
    first_stacked = s.dense_layers if s.experts else 0
    return parts[0] == "layers" and int(parts[1]) >= first_stacked


def forward(s: Spec, w: dict[str, Tensor], tokens: Tensor, ar: Arith) -> tuple[Tensor, dict]:
    """All positions' logits of ``tokens`` (B, S) under the flat weights
    ``w`` (float32 leaves), and the experts' auxiliary terms summed over the
    layers. Each layer is recomputed in the backward, so that the float32
    activations of a full-width step fit beside the float32 state."""
    x = w["embed"][tokens.long()]
    total: dict = {}
    for i in range(s.layers):
        tree = layer_tree(w, i)
        x, aux = torch.utils.checkpoint.checkpoint(
            lambda t, x, i=i: layer(t, s, i, x, ar), tree, x, use_reentrant=False)
        for key, val in aux.items():
            total[key] = total.get(key, 0.0) + val
    return unembed(w["unembed"], rmsnorm(x, w["final_norm"], s.eps), ar), total


@torch.no_grad()
def prefill_logits(s: Spec, seed: int, tokens: Tensor, ar: Arith | None = None,
                   dtype=torch.bfloat16) -> Tensor:
    """Last-position logits (B, V) of a causal forward over ``tokens`` (B, S),
    the weights drawn from ``seed`` a layer at a time and dropped after use."""
    ar = ar or Arith()
    x = None
    for part in draw(s, seed, tokens.device, dtype):
        if part[0] == "embed":
            x = part[1][tokens.long()].float()
        elif part[0] == "final_norm":
            g = part[1]
        elif part[0] == "layer":
            x, _ = layer(part[2], s, part[1], x, ar)
        else:
            return unembed(part[1], rmsnorm(x[:, -1], g, s.eps), ar)
    raise AssertionError("unreachable")
