"""Plain reference of Moonlight-16B-A3B (the DeepSeek-V3 layout) at one
chip's share (``configs/moonlight_16b.json``): token embedding; each layer
x + o(mla(rmsnorm(x))) then x + ffn(rmsnorm(x)), ffn a dense SwiGLU in the
first ``first_k_dense_replace`` layers and the expert block after them; a
final RMSNorm and an untied head without bias. No biases anywhere. Plain
torch in f32 (``common.mm``: TF32 off, or the control's TF32), written from
the published equations (DeepSeek-V3's modeling code):

- RMSNorm: x / sqrt(mean(x^2) + eps) * g.
- Multi-head latent attention, no query latent: q = z W_q viewed [B, T, H,
  n + r] (n = ``qk_nope_head_dim``, r = ``qk_rope_head_dim``) and split
  into q_nope and q_pe; [c, k_pe] = z W_kva, c of ``kv_lora_rank`` and one
  k_pe of r that every head shares; c = rmsnorm(c) (scale "gkv"); [k_nope,
  v] = c W_kvb viewed [B, T, H, n + ``v_head_dim``]. q_pe and k_pe rotated
  as DeepSeek-V3's ``apply_rotary_pos_emb`` does: each vector reordered
  ``view(r/2, 2).transpose(-1, -2).reshape``, then ``rotate_half`` with the
  tables of ``rope_theta`` over r (built here in float64). q = [q_nope,
  q_pe], k = [k_nope, k_pe] with k_pe expanded over the heads; scores
  scaled by 1/sqrt(n + r), causal. The scores are computed a block of
  queries at a time, each block under ``torch.utils.checkpoint``, against
  only the keys it can see, so that no [T, T] score tensor is held whole.
- Experts: s = sigmoid(x W_r) over all experts; the top-k set S of each
  token by s + b (b, the selection bias, zero in the cell; ``route`` is the
  selection); w_j = ``routed_scaling_factor`` * s_j / (sum over S of s +
  1e-20); the held experts' part, sum over S and held of
  w_j * down_j(silu(gate_j x) * up_j x), plus the shared expert's
  down(silu(gate x) * up x) of width ``n_shared_experts`` x
  ``moe_intermediate_size`` on every token.

W_o starts at zero (``param_spec``'s law "zeros"; every other matrix Xavier
uniform), as a zero-initialised residual branch does (the mellum2
reference says why).

The parameters are named "<i>.<key>" after the position i of their layer
in the program's net: the embedding 0 ("w"); layer l's attention 1 + 2l
("g", "wq", "wkva", "gkv", "wkvb", "wo"); its MLP 2 + 2l, dense ("g",
"gate", "up", "down") or experts ("g", "wr", "e<j>_gate", "e<j>_up",
"e<j>_down" of each held expert j, "shared_gate", "shared_up",
"shared_down"); the final norm 2L + 1 ("g"); the head 2L + 2 ("w")."""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import mm

QUERY_BLOCK = 512


def _held(config):
    return range(config["experts_held"])


def shared_width(config):
    return config["n_shared_experts"] * config["moe_intermediate_size"]


def param_spec(config, traffic):
    d, h = config["hidden_size"], config["num_attention_heads"]
    n, r = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    dv, rank = config["v_head_dim"], config["kv_lora_rank"]
    width, n_layers = config["moe_intermediate_size"], config["layers"]
    spec = [("0.w", (config["vocab"], d), "normal")]
    for layer in range(n_layers):
        a, m = "%d." % (1 + 2 * layer), "%d." % (2 + 2 * layer)
        spec += [(a + "g", (1, d), "ones"),
                 (a + "wq", (d, h * (n + r)), "xavier"),
                 (a + "wkva", (d, rank + r), "xavier"),
                 (a + "gkv", (1, rank), "ones"),
                 (a + "wkvb", (rank, h * (n + dv)), "xavier"),
                 (a + "wo", (h * dv, d), "zeros"),
                 (m + "g", (1, d), "ones")]
        if layer < config["first_k_dense_replace"]:
            dense = config["intermediate_size"]
            spec += [(m + "gate", (d, dense), "xavier"),
                     (m + "up", (d, dense), "xavier"),
                     (m + "down", (dense, d), "xavier")]
            continue
        spec += [(m + "wr", (d, config["n_routed_experts"]), "xavier")]
        for j in _held(config):
            spec += [(m + "e%d_gate" % j, (d, width), "xavier"),
                     (m + "e%d_up" % j, (d, width), "xavier"),
                     (m + "e%d_down" % j, (width, d), "xavier")]
        shared = shared_width(config)
        spec += [(m + "shared_gate", (d, shared), "xavier"),
                 (m + "shared_up", (d, shared), "xavier"),
                 (m + "shared_down", (shared, d), "xavier")]
    return spec + [("%d.g" % (2 * n_layers + 1), (1, d), "ones"),
                   ("%d.w" % (2 * n_layers + 2), (d, config["vocab"]),
                    "xavier")]


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rotary(config, t, device):
    """cos, sin [t, qk_rope_head_dim], f32: DeepSeek-V3's rotary init (no
    scaling), in float64."""
    dim, theta = config["qk_rope_head_dim"], config["rope_theta"]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    freqs = torch.outer(torch.arange(t, dtype=torch.float64), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().float().to(device), emb.sin().float().to(device)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope(x, cos, sin):
    """DeepSeek-V3's ``apply_rotary_pos_emb`` on x [..., T, r]."""
    *lead, r = x.shape
    x = x.reshape(*lead, r // 2, 2).transpose(-1, -2).reshape(*lead, r)
    return x * cos + _rotate_half(x) * sin


def _attend(q, k, v, q0, precision):
    """One block of queries from position q0 against keys 0..q0 + block."""
    scores = mm(q, k.transpose(-1, -2), precision) \
        * (1.0 / math.sqrt(q.shape[-1]))
    q_pos = q0 + torch.arange(q.shape[2], device=q.device)[:, None]
    k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
    scores = scores.masked_fill(k_pos > q_pos, float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v, precision)


def _blocked_attention(q, k, v, precision):
    t, out = q.shape[2], []
    for q0 in range(0, t, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, t)
        out.append(checkpoint(_attend, q[:, :, q0:q1], k[:, :, :q1],
                              v[:, :, :q1], q0, precision,
                              use_reentrant=False))
    return torch.cat(out, dim=2)


def _attention(p, x, config, precision):
    b, t, _ = x.shape
    h, eps = config["num_attention_heads"], config["rms_norm_eps"]
    n, r = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    dv, rank = config["v_head_dim"], config["kv_lora_rank"]
    xn = _rms(x, p["g"], eps)
    q = mm(xn, p["wq"], precision).view(b, t, h, n + r).transpose(1, 2)
    q_nope, q_pe = torch.split(q, [n, r], dim=-1)
    c, k_pe = torch.split(mm(xn, p["wkva"], precision), [rank, r], dim=-1)
    kv = mm(_rms(c, p["gkv"], eps), p["wkvb"], precision)
    kv = kv.view(b, t, h, n + dv).transpose(1, 2)
    k_nope, v = torch.split(kv, [n, dv], dim=-1)
    cos, sin = rotary(config, t, x.device)
    q_pe = rope(q_pe, cos, sin)
    k_pe = rope(k_pe.view(b, 1, t, r), cos, sin)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, h, t, r)], dim=-1)
    ctx = _blocked_attention(q, k, v, precision)
    return x + mm(ctx.transpose(1, 2).reshape(b, t, h * dv), p["wo"],
                  precision)


def swiglu(xn, gate, up, down, precision):
    return mm(F.silu(mm(xn, gate, precision)) * mm(xn, up, precision), down,
              precision)


def route(scores, top_k):
    """Each row's ``top_k`` experts by (biased) score."""
    return torch.topk(scores, top_k, dim=-1).indices


def experts_part(p, xn, config, precision, held=None, bias=None):
    """The routed experts' part of the expert block's output for the
    normalised rows xn [n, d]: the experts ``held`` (the configuration's
    held ones by default), each token's top-k found here by s + ``bias``
    (zero by default)."""
    scores = torch.sigmoid(mm(xn, p["wr"], precision))
    biased = scores if bias is None else scores + bias
    top = route(biased, config["num_experts_per_tok"])
    w = scores.gather(-1, top)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) \
        * config["routed_scaling_factor"]
    out = torch.zeros_like(xn)
    for j in (_held(config) if held is None else held):
        token, slot = torch.nonzero(top == j, as_tuple=True)
        xj = xn[token]
        out = out.index_add(0, token, w[token, slot, None] * swiglu(
            xj, p["e%d_gate" % j], p["e%d_up" % j], p["e%d_down" % j],
            precision))
    return out


def _mlp(p, x, config, dense, precision):
    xn = _rms(x, p["g"], config["rms_norm_eps"]).reshape(-1, x.shape[-1])
    if dense:
        y = swiglu(xn, p["gate"], p["up"], p["down"], precision)
    else:
        y = experts_part(p, xn, config, precision) + swiglu(
            xn, p["shared_gate"], p["shared_up"], p["shared_down"],
            precision)
    return x + y.reshape(x.shape)


def _layer_params(params, i):
    prefix = "%d." % i
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def forward(params, config, ids, precision):
    n_layers = config["layers"]
    x = params["0.w"][ids]
    for layer in range(n_layers):
        x = _attention(_layer_params(params, 1 + 2 * layer), x, config,
                       precision)
        x = _mlp(_layer_params(params, 2 + 2 * layer), x, config,
                 layer < config["first_k_dense_replace"], precision)
    x = _rms(x, params["%d.g" % (2 * n_layers + 1)], config["rms_norm_eps"])
    return mm(x, params["%d.w" % (2 * n_layers + 2)], precision)


def loss(logits, ids):
    """The mean over all positions of each next-token id's cross-entropy."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           ids.reshape(-1))
