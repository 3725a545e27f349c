"""The fused transformer-block forward probe on the card (the PyTorch
package's counterpart of bench_block_probe.py, K7).

Holds the fused block forward (csrc/block_fwd.cu, one launch: LN, the QKV
products, per-head attention, the output projection, LN, the GELU MLP and
both residuals) against its plain PyTorch version and against the tape
block's forward, then times them with the library call beside them. The
shapes are bench_block_probe.py's, the blocks of bench_all.py's config 6
(B 32, T 128, D 256, 8 heads, with and without the causal mask) and a
T=512 causal block, and 6b's block (B 4, T 2048, D 512, 8 heads, causal).
Each block is ``TransformerBlock(dim=D, num_heads=8, causal=..., seed=3)``
after ``random_seed(0)``, its input ``randn(B, T, D) * 0.5`` from numpy
seed 0.

For each shape it prints one JSON line: the kernel's max abs error against
the plain version and against the tape forward (both held at rtol 1e-4 and
an atol of 1e-4 of the plain output's largest value: f32 sums of depth up
to 4D in another order); the time a call of the kernel, the tape forward
(``attn="fused"``: the flash-attention kernel runs), the library call
(``torch.nn.TransformerEncoderLayer`` with the same weights, held to the
plain version at the same tolerance first) and the plain version; the
bound on the H100 (FLOPs over 67 TFLOP/s or bytes over 3.35 TB/s, the
larger); and ``vs_tape``, the tape forward's time over the kernel's (above
1: the kernel wins). On the card the times are device times by CUDA events
(``utils.timing.device_us``), with TF32 off. Writes no file:
BLOCK_PROBE.json holds the JAX package's TPU numbers.

Run on the card:  python bench_block_probe_torch.py
(--device cpu runs the plain version in the kernel's place, to rehearse
the script; its times are the CPU's host clock, labelled ``*_cpu_us``, not
a device metric. --tiny runs one small block in place of the four.)
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tinynn_autograd_tpu_torch import Tensor  # noqa: E402
from tinynn_autograd_tpu_torch.nn.layers import TransformerBlock  # noqa: E402
from tinynn_autograd_tpu_torch.ops import block_kernel  # noqa: E402
from tinynn_autograd_tpu_torch.utils.seeder import random_seed  # noqa: E402
from tinynn_autograd_tpu_torch.utils.timing import device_us  # noqa: E402

# (B, T, D, heads, causal)
CONFIGS = {"config6": (32, 128, 256, 8, False),
           "config6_causal": (32, 128, 256, 8, True),
           "t512_causal": (8, 512, 256, 8, True),
           "config6b": (4, 2048, 512, 8, True)}
TINY = {"tiny": (2, 16, 32, 4, True)}
EPS = 1e-5
RTOL = 1e-4
ATOL_OF_MAX = 1e-4  # of the plain output's largest absolute value
REPS = 20
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def tag(b, t, d, heads, causal):
    """bench_block_probe.py's name of a shape."""
    return "b%dt%dd%dh%d%s" % (b, t, d, heads, "c" if causal else "")


def build(b, t, d, heads, causal, device):
    """(block, its parameters, x) on ``device``: the JAX probe's block and
    input."""
    random_seed(0)
    blk = TransformerBlock(dim=d, num_heads=heads, causal=causal, seed=3)
    for k, v in blk.params.items():
        blk.params[k] = Tensor(v.data.to(device))
    x = np.random.RandomState(0).randn(b, t, d).astype(np.float32) * 0.5
    return blk, block_kernel.block_params(blk), torch.from_numpy(x).to(device)


def library_layer(params, heads, causal, t, device):
    """One PyTorch call that computes the same function: a pre-LN
    ``TransformerEncoderLayer`` in eval mode loaded with the block's
    weights (zero attention biases), as a function of x."""
    d, hidden = params["w1"].shape
    layer = torch.nn.TransformerEncoderLayer(
        d_model=d, nhead=heads, dim_feedforward=hidden, dropout=0.0,
        activation=lambda v: F.gelu(v, approximate="tanh"),
        layer_norm_eps=EPS, batch_first=True, norm_first=True).to(device)
    layer.eval()
    p = params
    with torch.no_grad():
        attn = layer.self_attn
        attn.in_proj_weight.copy_(torch.cat([p["wq"].T, p["wk"].T,
                                             p["wv"].T]))
        attn.in_proj_bias.zero_()
        attn.out_proj.weight.copy_(p["wo"].T)
        attn.out_proj.bias.zero_()
        for lin, w, bias in ((layer.linear1, "w1", "b1"),
                             (layer.linear2, "w2", "b2")):
            lin.weight.copy_(p[w].T)
            lin.bias.copy_(p[bias][0])
        for norm, g, be in ((layer.norm1, "g1", "be1"),
                            (layer.norm2, "g2", "be2")):
            norm.weight.copy_(p[g][0])
            norm.bias.copy_(p[be][0])
    mask = (torch.nn.Transformer.generate_square_subsequent_mask(
        t, device=device) if causal else None)

    def call(x):
        with torch.no_grad():
            return layer(x, src_mask=mask, is_causal=causal)

    return call


def hold(what, got, want):
    """Max abs error of ``got`` against ``want``; raises past rtol 1e-4
    and an atol of 1e-4 of ``want``'s largest absolute value."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    atol = ATOL_OF_MAX * float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)
    return float(np.max(np.abs(got - want)))


def bound_us(b, t, d, heads, causal):
    """(least us the H100 could take, "operations" or "bytes")."""
    flops, n_bytes = block_kernel.block_costs(b, t, d, heads, causal)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES
    return (1e6 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def call_us(fn, device, reps):
    """A call's time: device time by CUDA events on the card, the host's
    clock (mean over ``reps`` after one warm-up call) on the CPU."""
    if device.type == "cuda":
        return device_us(fn, reps=reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e6 * (time.perf_counter() - t0) / reps


def probe_shape(name, device, timed=True, reps=REPS, configs=CONFIGS):
    """One shape: the kernel (``block_fwd``: the plain version on the CPU)
    against the plain version and the tape forward, the library call
    against the plain version, then, when ``timed``, the time of each and
    the bound. Returns the JSON row."""
    b, t, d, heads, causal = configs[name]
    blk, params, x = build(b, t, d, heads, causal, device)

    def kernel():
        return block_kernel.block_fwd(x, params, heads, causal=causal,
                                      eps=EPS)

    def plain():
        return block_kernel.block_fwd_reference(x, params, heads,
                                                causal=causal, eps=EPS)

    def tape():
        return blk.forward(Tensor(x)).data

    library = library_layer(params, heads, causal, t, device)
    got, want = kernel(), plain()
    row = {"shape": tag(b, t, d, heads, causal), "name": name,
           "device": device.type,
           "max_abs_err_vs_plain": hold(name + " kernel vs plain", got, want),
           "max_abs_err_vs_tape": hold(name + " kernel vs tape", got,
                                       tape()),
           "library_max_abs_err_vs_plain": hold(
               name + " library vs plain", library(x), want),
           "atol": ATOL_OF_MAX * float(want.abs().max()), "rtol": RTOL}
    if not bool(torch.isfinite(got).all()) or got.shape != x.shape:
        raise AssertionError("%s: output not finite or of shape %s"
                             % (name, tuple(got.shape)))
    row["bound_us"], row["bound_by"] = bound_us(b, t, d, heads, causal)
    if timed:
        suffix = "_us" if device.type == "cuda" else "_cpu_us"
        for key, fn in (("kernel", kernel), ("tape", tape),
                        ("library", lambda: library(x)), ("plain", plain)):
            row[key + suffix] = call_us(fn, device, reps)
        row["vs_tape"] = row["tape" + suffix] / row["kernel" + suffix]
    return row


def main(args):
    device = torch.device(args.device)
    card = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": device.type, "card": card,
                      "reps": args.reps}), flush=True)
    configs = TINY if args.tiny else CONFIGS
    for name in configs:
        print(json.dumps(probe_shape(name, device, reps=args.reps,
                                     configs=configs)), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--reps", default=REPS, type=int)
    parser.add_argument("--tiny", action="store_true",
                        help="one small causal block (B 2, T 16, D 32, 4 "
                             "heads) in place of CONFIGS")
    main(parser.parse_args())
