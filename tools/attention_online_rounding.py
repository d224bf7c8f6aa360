#!/usr/bin/env python3
"""How far an online softmax moves the bf16 attention forward's o from
the exact-max reference, on the CPU.

    python3 tools/attention_online_rounding.py [B]

The port holds its bf16 attention forward (`attention_lse_fwd`,
`attention_fwd`) to the plain version `attention_lse_fwd_ref`, which forms
e = exp2(logit - m) with m the exact row max and rounds e to bf16 for the
product with v: at most FLIP_SHARE (1e-4, chip_smoke.py) of o may lie
outside TOL (rtol 2^-7, atol 1e-4).  This script emulates two bodies in
fp32 on the same inputs (q, k, v ~ N(0, 1) in bf16, packed as the ViT packs
them, B sequences of L = 256, H = 6, D = 64):

* exact max: the logits summed in another order (fp64, then fp32), so the
  bf16 rounding of an odd e goes the other way, as the card's tensor-core
  sums do;
* online softmax over 64-key tiles: a running max, e rounded to bf16
  against the max so far, o and s rescaled by exp2(m_old - m_new).

and prints the share of o outside TOL for each.  The online body rounds e
against a max that is not yet the final one, which moves o by far more than
the order of the sums does.  CPU only; no card, no timing.
"""

import sys

import torch

TOL = dict(rtol=2**-7, atol=1e-4)
FLIP_SHARE = 1e-4
L, H, D, TILE = 256, 6, 64, 64
LOG2E = 1.4426950408889634


def share_outside(got, ref):
    return float(((got - ref).abs() > TOL["atol"] + TOL["rtol"] * ref.abs()).float().mean())


def main():
    b = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    gen = torch.Generator().manual_seed(0)
    c = H * D
    qkv = torch.randn(b, L, 3 * c, generator=gen).to(torch.bfloat16)
    q, k, v = (qkv[..., i * c:(i + 1) * c].view(b, L, H, D) for i in range(3))
    qs = (q * torch.tensor(D**-0.5 * LOG2E, dtype=torch.bfloat16)).float()
    vf = v.float()

    def attend(logits):  # the exact-max body: e against the row max, in bf16 for e . v
        m = logits.amax(-1, keepdim=True)
        e = torch.exp2(logits - m)
        o = torch.einsum("bhqk,bkhd->bhqd", e.bfloat16().float(), vf)
        return (o / e.sum(-1, keepdim=True)).bfloat16().float()

    logits = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    ref = attend(logits)
    other = attend(torch.einsum("bqhd,bkhd->bhqk", qs.double(), k.double()).float())

    m = torch.full((b, H, L, 1), -float("inf"))
    s = torch.zeros(b, H, L, 1)
    o = torch.zeros(b, H, L, D)
    for j in range(0, L, TILE):  # the online body
        chunk = logits[..., j:j + TILE]
        m_new = torch.maximum(m, chunk.amax(-1, keepdim=True))
        f = torch.exp2(m - m_new)
        e = torch.exp2(chunk - m_new)
        s = s * f + e.sum(-1, keepdim=True)
        o = o * f + torch.einsum("bhqk,bkhd->bhqd", e.bfloat16().float(), vf[:, j:j + TILE])
        m = m_new
    online = (o / s).bfloat16().float()

    print(f"B={b} L={L} H={H} D={D}, o elements outside TOL {TOL} of the exact-max reference "
          f"(FLIP_SHARE {FLIP_SHARE}): exact max, other sum order "
          f"{share_outside(other, ref):.3e}; online softmax over {TILE}-key tiles "
          f"{share_outside(online, ref):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
