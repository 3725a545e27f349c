"""The latent-attention blocks' forward on the host: the mean of the
program's ``tinynn.mla`` span (``LatentAttentionBlock.forward``: the
projections, the latent norm, the rotations, q's and k's assembly, the
attention kernels' launch and the output projection; no read-back)."""

from harness import manifest


def read(ctx):
    return manifest.reader("program_totals").mean_ms("tinynn.mla")
