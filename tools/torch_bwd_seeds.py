#!/usr/bin/env python3
"""The attention backward kernels' errors at the tile-edge tests' shapes
over many draws of dL/do, on one NVIDIA card.

    python3 tools/torch_bwd_seeds.py [--seeds 16] [--all]

``tests/test_torch_port_cuda.py`` holds K2 and K5b against the plain
backward fed the kernel forward's o and lse, each gradient within the
dtype's bound of the plain version's max-abs, on one draw of dL/do. This
reads, for each case and over ``--seeds`` draws (generator seeds 0..n-1),
each gradient's error as a share of that allowance (> 1 fails the test):
- ``kernel``: the kernel against the plain version (f32 sums), the test's
  own reading;
- ``kernel/f64`` and ``plain/f64``: each against the same formula in
  float64 on the same o and lse. Where the kernel is as far from float64
  as the plain version is, the two differ by f32 rounding alone, and a
  reading past 1 says the bound is tighter than two f32 computations of
  the sum; where the kernel is much farther, the kernel is at fault.
Cases: the f32 cases with M >= 1024 (a dslopes sum of 4M products and
more), K2 and K5b with H and with one key/value head; ``--all`` every
tile-edge case in both dtypes.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def f64_backward(q, k, v, slopes, key_lens, seed, o, lse, do, scale, offset, causal, rate,
                 per_head):
    """The plain backward's formula in float64 on the kernel forward's o
    and lse (the slope gradients over each key's distance from the row's
    nearest valid key, ``fa._slope_arms``): (dq, dk, dv, dslopes) shaped as
    the kernel's outputs."""
    from isp_tts_tpu_torch.ops import flash_attention as fa

    B, N, H, _ = q.shape
    M = k.shape[1]
    dist, lower, _ = fa._geometry(N, M, offset, slopes, q.device)
    dist, sl = dist.double(), slopes.double()
    bias = torch.where(lower[:, None, :], sl[0][None, :, None] * dist[:, None, :],
                       sl[1][None, :, None] * dist[:, None, :])
    kk, vv = (k, v) if per_head else (k[:, :, None], v[:, :, None])
    kd, vd = (x.double().expand(-1, -1, H, -1) if x.shape[2] == 1 else x.double()
              for x in (kk, vv))
    qd, dod = q.double(), do.double()
    lse = (lse.transpose(1, 2) if per_head else lse.reshape(B, N, H)).double()
    s = torch.einsum("bnhd,bmhd->bnhm", qd, kd) * scale + bias[None]
    s = s.masked_fill(~fa._valid(key_lens, lower, causal, M, q.device), fa.NEG_INF)
    p = torch.exp(s - lse[..., None])
    delta = (dod * o.double()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bnhd,bmhd->bnhm", dod, vd)
    pv = p
    drop = fa.drop_params(rate)
    if drop is not None:
        keep = (fa.head_keep_mask(B, H, N, M, seed, drop[0]).permute(0, 2, 1, 3) if per_head
                else fa.mqa_keep_mask(B, N, H, M, seed, drop[0])).double() * drop[1]
        pv, dp = p * keep, dp * keep
    dv = torch.einsum("bnhm,bnhd->bmhd", pv, dod)
    ds = p * (dp - delta)
    dq = torch.einsum("bnhm,bmhd->bnhd", ds, kd) * scale
    dk = torch.einsum("bnhm,bnhd->bmhd", ds, qd) * scale
    if kk.shape[2] == 1:
        dk, dv = dk.sum(dim=2, keepdim=True), dv.sum(dim=2, keepdim=True)
    dsd = ds * fa._slope_arms(key_lens, offset, causal, N, M, q.device, torch.float64)
    low = lower[None, :, None, :]
    dslopes = torch.stack([torch.where(low, dsd, 0.0).sum(dim=(0, 1, 3)),
                           torch.where(low, 0.0, dsd).sum(dim=(0, 1, 3))])
    return dq, dk.reshape(k.shape), dv.reshape(v.shape), dslopes


def shares(got, ref, bound, max_dist):
    """Each gradient's max |got - ref| over ``bound`` times its scale, as
    the tests' ``_assert_within`` sets it (one key: dv's scale)."""
    one_key = ref[1].shape[1] == 1
    out = []
    for i, (a, b) in enumerate(zip(got, ref)):
        scale = b.double().abs().max().item()
        if one_key and i != 2:
            scale = ref[2].double().abs().max().item() * (max_dist if i == 3 else 1)
        out.append((a.double() - b.double()).abs().max().item() / (bound * max(scale, 1e-30)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--all", action="store_true", help="every tile-edge case, both dtypes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import test_torch_port_cuda as tc

    from isp_tts_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.device("cuda")
    dtypes = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
    cases = [(name, B, N, M, H, hkv, offset, causal, rate) + db
             for B, N, M, H, offset, causal, rate in tc.BWD_EDGE_CASES
             for name, hkvs in (("K2", (1,)), ("K5b", (H, 1))) for hkv in hkvs
             for db in dtypes
             if args.all or (M >= 1024 and db[0] == torch.float32)]
    print(f"{torch.cuda.get_device_name(0)}; {len(cases)} cases x {args.seeds} draws; "
          "max over draws of error / allowance (> 1 fails), draws past 1", flush=True)
    for name, B, N, M, H, hkv, offset, causal, rate, dtype, bound in cases:
        q, k, v, slopes, key_lens, q_lens = tc._flash(card, B, N, M, H, hkv, dtype, seed=2)
        per_head = name == "K5b"
        if not per_head:
            k, v = k[:, :, 0].contiguous(), v[:, :, 0].contiguous()
        fwd, bwd, plain = ((fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_reference) if per_head
                           else (fa.mqa_fwd, fa.mqa_bwd, fa.mqa_bwd_reference))
        seed = torch.tensor([41 if per_head else 37], dtype=torch.int32, device=card)
        o, lse = fwd(q, k, v, slopes, key_lens, 0.125, offset, q_lens, causal, rate, seed)
        worst = {key: [0.0] * 4 for key in ("kernel", "kernel/f64", "plain/f64")}
        past = [0] * 4
        for s in range(args.seeds):
            gen = torch.Generator(device=card).manual_seed(s)
            w = torch.randn(q.shape, generator=gen, device=card).to(dtype)
            a = (q, k, v, slopes, key_lens, q_lens, seed, o, lse, w, 0.125, offset, causal,
                 rate)
            got, ref = bwd(*a), plain(*a)
            exact = f64_backward(q, k, v, slopes, key_lens, seed, o, lse, w, 0.125, offset,
                                 causal, rate, per_head)
            dist = N + abs(offset)
            read = {"kernel": shares(got, ref, bound, dist),
                    "kernel/f64": shares(got, exact, bound, dist),
                    "plain/f64": shares(ref, exact, bound, dist)}
            for key, vals in read.items():
                worst[key] = [max(x, y) for x, y in zip(worst[key], vals)]
            past = [n + (x > 1.0) for n, x in zip(past, read["kernel"])]
            del got, ref, exact
        torch.cuda.empty_cache()
        print(f"{name} B={B} N={N} M={M} H={H} Hkv={hkv} offset={offset} causal={int(causal)} "
              f"rate={rate} {str(dtype)[6:]}: " + "; ".join(
                  f"{g} " + " ".join(f"{key} {worst[key][i]:.3f}" for key in worst)
                  + f" past {past[i]}/{args.seeds}" for i, g in enumerate(tc.GRAD_NAMES)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
