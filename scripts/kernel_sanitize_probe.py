#!/usr/bin/env python3
"""One small launch of each flash kernel and of K5, for a run under
``compute-sanitizer`` (ROADMAP C4):

    compute-sanitizer --tool racecheck python3 scripts/kernel_sanitize_probe.py
    compute-sanitizer --tool synccheck python3 scripts/kernel_sanitize_probe.py

K1 at B 1, S 16 (chip_smoke.py's first check) in both tile configs, the
flash backward (K2, K3) at B 1, S 128, K5 at B 1, S 256; every output
held against its plain version at chip_smoke.py's limits. Builds the
kernels first (outside the launches the sanitizer reports on). Exits 1
on a disagreement.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch

    import chip_smoke as cs
    from k8s_tpu_torch.ops import _kernels
    from k8s_tpu_torch.ops import attention as attn

    _kernels.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    scale, errs = 128 ** -0.5, {}
    for config in (1, 0):
        q, k, v = rnd(1, 16, 32, 128), rnd(1, 16, 8, 128), rnd(1, 16, 8, 128)
        o, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True, config=config)
        ref, ref_lse = attn.flash_fwd_plain(q.float(), k.float(), v.float(), True, scale)
        errs[f"k1_config{config}"] = cs.row_rel_err(o, ref)
        errs[f"k1_config{config}_lse"] = (lse - ref_lse).abs().max().item()
    q, k, v, do = rnd(1, 128, 32, 128), rnd(1, 128, 8, 128), rnd(1, 128, 8, 128), \
        rnd(1, 128, 32, 128)
    o, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True)
    got = attn.flash_bwd(q, k, v, o, lse, do, True, scale)
    ref = attn.flash_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                               do.float(), True, scale)
    for n, x, r in zip(("dq", "dk", "dv"), got, ref):
        errs[n] = cs.row_rel_err(x, r, floor=cs.FLASH_BWD_ROW_FLOOR)
    qd, kn, vn = rnd(1, 32, 128), rnd(1, 8, 128), rnd(1, 8, 128)
    (kc, ks), (vc, vs) = attn.quantize_kv_rows(rnd(1, 8, 256, 128)), \
        attn.quantize_kv_rows(rnd(1, 8, 256, 128))
    pos = torch.tensor([200], dtype=torch.int32, device="cuda")
    caches, plain = [t.clone() for t in (kc, vc, ks, vs)], [t.clone() for t in (kc, vc, ks, vs)]
    o = attn.decode_attention_update_q8(qd, kn, vn, *caches, pos, scale)[0]
    ref = attn.decode_attention_q8_plain(qd.float(), kn.float(), vn.float(), *plain,
                                         pos, scale)
    errs["k5"] = cs.row_rel_err(o, ref)
    torch.cuda.synchronize()
    appends = all(torch.equal(a, b) for a, b in zip(caches, plain))
    limits = {"k1_config1": cs.FLASH_REL_TOL, "k1_config0": cs.FLASH_REL_TOL,
              "k1_config1_lse": cs.FLASH_LSE_TOL, "k1_config0_lse": cs.FLASH_LSE_TOL,
              "dq": cs.FLASH_BWD_REL_TOL, "dk": cs.FLASH_BWD_REL_TOL,
              "dv": cs.FLASH_BWD_REL_TOL, "k5": cs.DECODE_Q8_REL_TOL}
    ok = appends and all(errs[n] <= lim for n, lim in limits.items())
    print(json.dumps({"ok": ok, "errs": errs, "k5_appends_equal": appends}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
