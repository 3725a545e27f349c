"""Plain reference of Mellum 2 at one chip's share (``configs/
mellum2_12b.json``): token embedding; each layer x + o(attn(rmsnorm(x)))
then x + moe(rmsnorm(x)); a final RMSNorm and an untied head without bias.
No biases anywhere. Plain torch in f32 (``common.mm``: TF32 off, or the
control's TF32), written from the published equations:

- RMSNorm: x / sqrt(mean(x^2) + eps) * g.
- Attention: q [B, 32, T, 128], k and v [B, 4, T, 128], each kv head
  repeated for its 8 query heads; q and k rotated with ``rotate_half``
  by the layer type's table (plain RoPE on sliding layers, YaRN on full
  ones, both built here in float64 from the configuration's
  ``rope_parameters``); scores scaled by 1/sqrt(128), causal, and on
  sliding layers limited to the keys in (p - window, p]. The scores are
  computed a block of queries at a time, each block under
  ``torch.utils.checkpoint``, against only the keys it can see, so that no
  [T, T] score tensor is ever held whole.
- Experts: s = softmax(x W_r) over all experts, the top-k set S of each
  token found here from these scores, w_j = s_j / sum over S of s; the
  held experts' part, sum over S and held of
  w_j * down_j(silu(gate_j x) * up_j x).

The attention's output projection o starts at zero (``param_spec``'s
law "zeros"; every other matrix Xavier uniform), as a zero-initialised
residual branch does: random attention averages its values over the
visible keys, and with o drawn at Xavier's scale that common part
outgrows the tokens' own embeddings from the first layer on, so that the
router sends nearly every token to one set of experts.

The parameters are named "<i>.<key>" after the position i of their layer
in the program's net: the embedding 0 ("w"); layer l's attention 1 + 2l
("g", "wq", "wk", "wv", "wo") and experts 2 + 2l ("g", "wr" and
"e<j>_gate", "e<j>_up", "e<j>_down" of each held expert j); the final norm
2L + 1 ("g"); the head 2L + 2 ("w")."""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import mm

QUERY_BLOCK = 512


def _held(config):
    return range(config["experts_held"])


def param_spec(config, traffic):
    d, hd = config["hidden_size"], config["head_dim"]
    q = config["num_attention_heads"] * hd
    kv = config["num_key_value_heads"] * hd
    width, n_layers = config["moe_intermediate_size"], config["layers"]
    spec = [("0.w", (config["vocab"], d), "normal")]
    for layer in range(n_layers):
        a, m = "%d." % (1 + 2 * layer), "%d." % (2 + 2 * layer)
        spec += [(a + "g", (1, d), "ones"), (a + "wq", (d, q), "xavier"),
                 (a + "wk", (d, kv), "xavier"), (a + "wv", (d, kv), "xavier"),
                 (a + "wo", (q, d), "zeros"),
                 (m + "g", (1, d), "ones"),
                 (m + "wr", (d, config["num_experts"]), "xavier")]
        for j in _held(config):
            spec += [(m + "e%d_gate" % j, (d, width), "xavier"),
                     (m + "e%d_up" % j, (d, width), "xavier"),
                     (m + "e%d_down" % j, (width, d), "xavier")]
    return spec + [("%d.g" % (2 * n_layers + 1), (1, d), "ones"),
                   ("%d.w" % (2 * n_layers + 2), (d, config["vocab"]),
                    "xavier")]


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def _inv_freq(config, kind):
    """(each dim pair's frequency, float64; the tables' scale) of the layer
    type ``kind``, as HF transformers' default and YaRN rotary inits."""
    rope, dim = config["rope_parameters"][kind], config["head_dim"]
    theta = rope["rope_theta"]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64)
                          / dim)
    if rope["rope_type"] == "default":
        return inv, 1.0
    assert rope["rope_type"] == "yarn", rope

    def correction_dim(rotations):
        return (dim * math.log(rope["original_max_position_embeddings"]
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(rope["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rope["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    extrapolated = 1 - ramp
    inv = inv / rope["factor"] * (1 - extrapolated) + inv * extrapolated
    return inv, rope["attention_factor"]


def rotary(config, kind, t, device):
    """cos, sin [t, head_dim], f32."""
    inv, scale = _inv_freq(config, kind)
    freqs = torch.outer(torch.arange(t, dtype=torch.float64), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return ((emb.cos() * scale).float().to(device),
            (emb.sin() * scale).float().to(device))


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _attend(q, k, v, q0, k0, window, precision):
    """One block of queries from position q0 against keys from k0."""
    scores = mm(q, k.transpose(-1, -2), precision) \
        * (1.0 / math.sqrt(q.shape[-1]))
    q_pos = q0 + torch.arange(q.shape[2], device=q.device)[:, None]
    k_pos = k0 + torch.arange(k.shape[2], device=q.device)[None, :]
    visible = k_pos <= q_pos
    if window is not None:
        visible &= q_pos - k_pos < window
    scores = scores.masked_fill(~visible, float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v, precision)


def _blocked_attention(q, k, v, window, precision):
    group = q.shape[1] // k.shape[1]
    k, v = (y.repeat_interleave(group, dim=1) for y in (k, v))
    t, out = q.shape[2], []
    for q0 in range(0, t, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, t)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        out.append(checkpoint(_attend, q[:, :, q0:q1], k[:, :, k0:q1],
                              v[:, :, k0:q1], q0, k0, window, precision,
                              use_reentrant=False))
    return torch.cat(out, dim=2)


def _attention(p, x, config, kind, precision):
    b, t, _ = x.shape
    h, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["head_dim"]
    xn = _rms(x, p["g"], config["rms_norm_eps"])
    q = mm(xn, p["wq"], precision).view(b, t, h, hd).transpose(1, 2)
    k = mm(xn, p["wk"], precision).view(b, t, hkv, hd).transpose(1, 2)
    v = mm(xn, p["wv"], precision).view(b, t, hkv, hd).transpose(1, 2)
    cos, sin = rotary(config, kind, t, x.device)
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    window = config["sliding_window"] if kind == "sliding_attention" \
        else None
    ctx = _blocked_attention(q, k, v, window, precision)
    return x + mm(ctx.transpose(1, 2).reshape(b, t, h * hd), p["wo"],
                  precision)


def route(scores, top_k):
    """Each row's ``top_k`` experts by score."""
    return torch.topk(scores, top_k, dim=-1).indices


def experts_part(p, xn, config, precision):
    """The held experts' part of the expert block's output for the
    normalised rows xn [n, d]."""
    scores = torch.softmax(mm(xn, p["wr"], precision), dim=-1)
    top = route(scores, config["num_experts_per_tok"])
    w = scores.gather(-1, top)
    if config["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(xn)
    for j in _held(config):
        token, slot = torch.nonzero(top == j, as_tuple=True)
        xj = xn[token]
        h = F.silu(mm(xj, p["e%d_gate" % j], precision)) \
            * mm(xj, p["e%d_up" % j], precision)
        out = out.index_add(0, token, w[token, slot, None]
                            * mm(h, p["e%d_down" % j], precision))
    return out


def _experts(p, x, config, precision):
    xn = _rms(x, p["g"], config["rms_norm_eps"]).reshape(-1, x.shape[-1])
    return x + experts_part(p, xn, config, precision).reshape(x.shape)


def _layer_params(params, i):
    prefix = "%d." % i
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def forward(params, config, ids, precision):
    n_layers = config["layers"]
    x = params["0.w"][ids]
    for layer, kind in enumerate(config["layer_types"][:n_layers]):
        x = _attention(_layer_params(params, 1 + 2 * layer), x, config, kind,
                       precision)
        x = _experts(_layer_params(params, 2 + 2 * layer), x, config,
                     precision)
    x = _rms(x, params["%d.g" % (2 * n_layers + 1)], config["rms_norm_eps"])
    return mm(x, params["%d.w" % (2 * n_layers + 2)], precision)


def loss(logits, ids):
    """The mean over all positions of each next-token id's cross-entropy."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           ids.reshape(-1))
