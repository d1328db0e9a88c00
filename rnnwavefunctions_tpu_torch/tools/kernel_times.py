"""Times the GRU kernels on one CUDA card, for A/B comparisons of kernel
designs within one call:

    python -m rnnwavefunctions_tpu_torch.tools.kernel_times [--label L]

Run it from the root of each checkout to compare (the package is imported
from the working directory; this file may also be run by path from another
checkout's root, with that root on ``PYTHONPATH``), in turns: a, b, b, a.  At
the flagship shapes (N=100, U=50, B=500; weights from PRNN1D/CRNNU1 seeds
1234/4321 with seeded noise, as ``chip_smoke.py``'s) it reports, in ms per
call with CUDA events over 20 launches after 2 warm-ups: K1, K2 and, where
the checkout has them, K1 storing K2's replay and K2 from that replay
(``GRULogProb``'s forward and backward); ``torch.nn.GRU`` (cuDNN) forward
and backward on K1's trunk; K3, K4, B5, B6a, B6b, K3 at N=1000 with B=64 (5
launches), B19 and ``torch.nn.GRU`` forward on B19's inputs; B17 and B18
(N=1000, S=64); B15 and B16 at the MDRNN flagship (16x16, U=50, B=500,
``MDRNN2D`` seed 2468 with ``chip_smoke.py``'s noise and halved recurrent
matrices; 5 launches) and, where the checkout takes them, B16 at each
suffix tile T and B17/B18 with one and two samples per reverse-sweep block;
B8, B10 and B11 at the J1-J2 flagship (``CRNNU1`` seed 4321, J1J2(100,
J2=0.2), open chain, zero-magnetisation samples); B12, B12 storing B14's
replay where the checkout has it, B14 and B14 from that replay at the MDRNN
flagship; B7 and B9 on the J1-J2 samples and, where the checkout has them,
B9's replay and B9 from it; B19 (storing the gates where the checkout
takes it) and B20 on two random cotangent sets (from B19's stored gates and
alone where the checkout takes them); B13; B21 on SR-Gram-like systems at
S=64, 100, 230, 250, 500 and 1000 beside Cholesky, with the path it took where
the checkout reports one; B11 at the J1-J2 cell's N=1000, S=64; then K3's
(at N=100 and at N=1000, S=64), K2's, B16's, B17/B18's, B10's, B11's (also
at N=1000, S=64; the suffix pass under either kernel's name), B14's (alone
and from the replay), B9's (alone and from the replay) and B20's launches
apart by ``torch.profiler`` over 10 calls (K3 and B16 over 3).  The card's
name and power limit come first, a JSON line last.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess

import torch


def _model(pkg, cls: str, n: int, u: int, seed: int, dev):
    gen = torch.Generator().manual_seed(seed)
    model = getattr(pkg, cls)(n, (u,), impl="kernel", device=dev).init(gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen).to(dev))
    return tuple(t.detach() for t in model.weights())


def _cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _cudnn_gru(trunk, dev) -> torch.nn.GRU:
    """``torch.nn.GRU`` holding a trunk (wx, wh, bx, bh) in the JAX layout."""
    gru = torch.nn.GRU(2, trunk[1].shape[0], batch_first=True).to(dev)
    with torch.no_grad():
        for p, src in zip((gru.weight_ih_l0, gru.weight_hh_l0, gru.bias_ih_l0, gru.bias_hh_l0),
                          (trunk[0].T, trunk[1].T, trunk[2], trunk[3])):
            p.copy_(src)
    return gru


def _profiled(fn, parts, calls: int = 10) -> dict:
    """Device ms per call of each launch whose kernel name holds parts[label]."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {label: sum(e.self_device_time_total for e in prof.key_averages()
                       if key in e.key) / 1e3 / calls for label, key in parts.items()}


def _mdrnn(pkg, dev):
    gen = torch.Generator().manual_seed(2468)
    model = pkg.MDRNN2D(16, 16, 50, impl="kernel", device=dev).init(gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen).to(dev))
        model.cell.wh.mul_(0.5)
        model.cell.wv.mul_(0.5)
    return tuple(t.detach() for t in model.weights())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="", help="a name printed with the results")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    import rnnwavefunctions_tpu_torch as pkg
    from rnnwavefunctions_tpu_torch.ops import fused_crnn, fused_crnn_bwd, fused_gru, fused_gru_bwd
    from rnnwavefunctions_tpu_torch.ops import fused_jac, sr_cg
    from rnnwavefunctions_tpu_torch.ops import fused_mdrnn, fused_mdrnn_bwd
    from rnnwavefunctions_tpu_torch.ops import j1j2_exchange_kernel as jk
    from rnnwavefunctions_tpu_torch.ops import mdrnn_flip_kernel as mk
    from rnnwavefunctions_tpu_torch.ops import tfim_flip_kernel as tk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    w = _model(pkg, "PRNN1D", 100, 50, 1234, dev)
    wc = _model(pkg, "CRNNU1", 100, 50, 4321, dev)
    trunk = wc[:4]
    gen = torch.Generator().manual_seed(99)
    s = (torch.rand(500, 100, generator=gen) < 0.5).to(torch.int32).to(dev)
    g = torch.randn(500, generator=gen).to(dev)
    x0 = fused_jac.input_onehot_rows(s)
    gru = _cudnn_gru(trunk, dev)
    gru_k = _cudnn_gru(w[:4], dev)
    gout = torch.randn(500, 100, 50, generator=gen).to(dev)

    def cudnn_fwd_bwd():
        gru_k(x0)[0].backward(gout)

    times = {
        "K1": _cuda_ms(lambda: fused_gru.gru_log_prob(w, s)),
        "K2": _cuda_ms(lambda: fused_gru_bwd.gru_log_prob_bwd(w, s, g)),
    }
    if "store" in inspect.signature(fused_gru.gru_log_prob).parameters:
        replay = fused_gru.gru_log_prob(w, s, store=True)
        times["K1 storing"] = _cuda_ms(lambda: fused_gru.gru_log_prob(w, s, store=True))
        times["K2 from replay"] = _cuda_ms(
            lambda: fused_gru_bwd.gru_log_prob_bwd(w, s, g, replay=replay))
    times["cuDNN GRU fwd+bwd"] = _cuda_ms(cudnn_fwd_bwd)
    times.update({
        "K3": _cuda_ms(lambda: tk.tfim_sample_and_flip_sum(w, 500, 100, 3, 4)),
        "K4": _cuda_ms(lambda: tk.tfim_flip_ratio_sum(w, s)),
        "B5": _cuda_ms(lambda: fused_gru.gru_sample(w, 500, 100, 3, 4)),
        "B6a": _cuda_ms(lambda: tk.tfim_flip_log_probs(w, s)),
        "B6b": _cuda_ms(lambda: tk.tfim_sample_and_flip_sum(w, 500, 100, 3, 4, per_flip=True)),
        "K3 N=1000 S=64": _cuda_ms(lambda: tk.tfim_sample_and_flip_sum(w, 64, 1000, 3, 4),
                                   reps=5),
        "B19": _cuda_ms(lambda: fused_jac.rollout_hist(trunk, s)),
        "cuDNN GRU": _cuda_ms(lambda: gru(x0)),
    })
    s_long = (torch.rand(64, 1000, generator=gen) < 0.5).to(torch.int32).to(dev)
    times["B17"] = _cuda_ms(lambda: fused_jac.jac_sweep(w, s))
    times["B18"] = _cuda_ms(lambda: fused_jac.jac_sweep(w, s_long), reps=10)
    wm = _mdrnn(pkg, dev)
    lat = (torch.rand(500, 16, 16, generator=gen) < 0.5).to(torch.int32).to(dev)
    times["B15"] = _cuda_ms(lambda: mk.mdrnn_flip_ratio_sum(wm, lat), reps=5)
    times["B16"] = _cuda_ms(lambda: mk.mdrnn_sample_and_flip_sum(wm, 500, 16, 16, 3, 4), reps=5)
    split = _profiled(lambda: mk.mdrnn_sample_and_flip_sum(wm, 500, 16, 16, 3, 4),
                      {"B16 base pass": "mdrnn_sweep_kernel", "B16 suffix pass": "suffix_kernel",
                       "B16 ratio sum": "mdrnn_flip_sum_kernel"}, calls=3)
    # B17's launches: this tree's replay and reverse sweep, or the one
    # warp-per-sample kernel of earlier trees
    for name, s_in in (("B17", s), ("B18", s_long)):
        split.update(_profiled(lambda: fused_jac.jac_sweep(w, s_in),
                               {f"{name} replay": "flip_base_kernel",
                                f"{name} reverse sweep": "bwd_sweep_kernel",
                                f"{name} one-warp kernel": "jac_sweep_kernel"}))
    # K3's launches at N=100, B=500 and at N=1000, S=64 (its suffix pass by
    # either kernel's name: flip_suffix_rs_kernel, or flip_suffix_kernel
    # past U = 56 and in earlier trees)
    for name, call in (("K3", lambda: tk.tfim_sample_and_flip_sum(w, 500, 100, 3, 4)),
                       ("K3 N=1000 S=64", lambda: tk.tfim_sample_and_flip_sum(w, 64, 1000, 3, 4))):
        split.update(_profiled(call, {f"{name} base pass": "flip_base_kernel",
                                      f"{name} suffix pass": "flip_suffix",
                                      f"{name} ratio sum": "flip_sum_kernel"}, calls=3))
    # K2's launches: this tree's stages a-c and the chunk sum, or the one
    # warp-per-sample kernel of earlier trees
    split.update(_profiled(lambda: fused_gru_bwd.gru_log_prob_bwd(w, s, g),
                           {"K2 replay": "flip_base_kernel", "K2 reverse sweep": "bwd_sweep_kernel",
                            "K2 weight cotangent": "bwd_weights_kernel",
                            "K2 chunk sum": "sum_partials_kernel",
                            "K2 one-warp kernel": "gru_bwd_kernel"}))
    # the J1-J2 kernels on zero-magnetisation samples, and their launches:
    # base pass, bond lists, suffix pass, sum
    info = pkg.J1J2(100, j2=0.2).exchange_kernel_info
    sector = (torch.rand(500, 100, generator=gen).argsort(dim=1) < 50).to(torch.int32).to(dev)
    b10 = lambda: jk.j1j2_exchange_offdiag(wc, sector, u1=True, **info)  # noqa: E731
    b11 = lambda: jk.j1j2_sample_and_exchange(wc, 500, 100, 3, 4, u1=True, **info)  # noqa: E731
    times["B8"] = _cuda_ms(lambda: fused_crnn.crnn_sample(wc, 500, 100, 3, 4, True))
    times["B10"] = _cuda_ms(b10)
    times["B11"] = _cuda_ms(b11)
    # B11 at the J1-J2 cell's N=1000, S=64 as well; the suffix pass by either
    # kernel's name: exchange_suffix_rs_kernel, or exchange_suffix_kernel past
    # U = 56 and in earlier trees
    info_long = pkg.J1J2(1000, j2=0.2, marshall_sign=True).exchange_kernel_info
    b11_long = lambda: jk.j1j2_sample_and_exchange(  # noqa: E731
        wc, 64, 1000, 3, 4, u1=True, **info_long)
    times["B11 N=1000 S=64"] = _cuda_ms(b11_long, reps=10)
    for name, fn in (("B10", b10), ("B11", b11), ("B11 N=1000 S=64", b11_long)):
        split.update(_profiled(fn, {f"{name} base pass": "exchange_base_kernel",
                                    f"{name} bond lists": "exchange_list_kernel",
                                    f"{name} suffix pass": "exchange_suffix",
                                    f"{name} sum": "exchange_sum_kernel"}))
    # B12 and B14, and B14 from B12's stored replay where the checkout has it
    gm = torch.randn(500, generator=gen).to(dev)
    times["B12"] = _cuda_ms(lambda: fused_mdrnn.mdrnn_log_prob(wm, lat), reps=10)
    times["B14"] = _cuda_ms(lambda: fused_mdrnn_bwd.mdrnn_log_prob_bwd(wm, lat, gm), reps=10)
    b14_parts = {"B14 replay": "mdrnn_sweep_kernel", "B14 reverse sweep": "mdrnn_bwd_sweep_kernel",
                 "B14 weight cotangent": "mdrnn_bwd_weights_kernel",
                 "B14 chunk sum": "sum_partials_kernel", "B14 one-warp kernel": "mdrnn_bwd_kernel"}
    split.update(_profiled(lambda: fused_mdrnn_bwd.mdrnn_log_prob_bwd(wm, lat, gm), b14_parts))
    if "store" in inspect.signature(fused_mdrnn.mdrnn_log_prob).parameters:
        mreplay = fused_mdrnn.mdrnn_log_prob(wm, lat, store=True)
        times["B12 storing"] = _cuda_ms(lambda: fused_mdrnn.mdrnn_log_prob(wm, lat, store=True),
                                        reps=10)
        from_replay = lambda: fused_mdrnn_bwd.mdrnn_log_prob_bwd(  # noqa: E731
            wm, lat, gm, replay=mreplay)
        times["B14 from replay"] = _cuda_ms(from_replay, reps=10)
        split.update({f"{k} (from replay)": v for k, v in _profiled(
            from_replay, {k: v for k, v in b14_parts.items() if k != "B14 replay"}).items()})
    # B7 and B9 on the J1-J2 samples; B9's replay and B9 from it where the
    # checkout has them
    g_re, g_im = torch.randn(2, 500, generator=gen).to(dev)
    b9 = lambda: fused_crnn_bwd.crnn_log_amp_bwd(wc, sector, g_re, g_im, True)  # noqa: E731
    times["B7"] = _cuda_ms(lambda: fused_crnn.crnn_log_amp_parts(wc, sector, True))
    times["B9"] = _cuda_ms(b9)
    b9_parts = {"B9 replay": "exchange_base_kernel", "B9 reverse sweep": "bwd_sweep_kernel",
                "B9 weight cotangent": "bwd_weights_kernel", "B9 chunk sum": "sum_partials_kernel",
                "B9 one-warp kernel": "crnn_bwd_kernel"}
    split.update(_profiled(b9, b9_parts))
    if hasattr(fused_crnn, "crnn_replay"):
        creplay = fused_crnn.crnn_replay(wc, sector, True)
        times["B9 replay"] = _cuda_ms(lambda: fused_crnn.crnn_replay(wc, sector, True))
        b9_from = lambda: fused_crnn_bwd.crnn_log_amp_bwd(  # noqa: E731
            wc, sector, g_re, g_im, True, replay=creplay)
        times["B9 from replay"] = _cuda_ms(b9_from)
        split.update({f"{k} (from replay)": v for k, v in _profiled(
            b9_from, {k: v for k, v in b9_parts.items() if k != "B9 replay"}).items()})
    # B19 storing the gates, and B20 from them, where the checkout takes them
    douts = torch.randn(2, 500, 100, 50, generator=gen).to(dev)
    hist = fused_jac.rollout_hist(trunk, s)
    b20 = lambda: fused_jac.sweep_dgates(trunk, s, hist, douts)  # noqa: E731
    b20_parts = {"B20 B19 storing": "rollout_hist_kernel", "B20 reverse sweep": "bwd_sweep_kernel",
                 "B20 one-warp kernel": "sweep_dgates_kernel"}
    if "store" in inspect.signature(fused_jac.rollout_hist).parameters:
        _, gates = fused_jac.rollout_hist(trunk, s, store=True)
        times["B19 storing"] = _cuda_ms(lambda: fused_jac.rollout_hist(trunk, s, store=True))
        times["B20 alone"] = _cuda_ms(b20)
        split.update({f"{k} (alone)": v for k, v in _profiled(b20, b20_parts).items()})
        b20 = lambda: fused_jac.sweep_dgates(trunk, s, hist, douts, gates=gates)  # noqa: E731
    times["B20"] = _cuda_ms(b20)
    split.update(_profiled(b20, b20_parts))
    # B13, and B21 on SR-Gram-like systems at the N=1000 chain's S=64, at
    # S=100, 230 and 250 (a cluster of 4 where the checkout chooses a path by
    # S, else the grid), the TFIM's S=500 and the J1-J2 2S=1000, beside
    # Cholesky; the path taken where the checkout reports it
    times["B13"] = _cuda_ms(lambda: fused_mdrnn.mdrnn_sample(wm, 500, 16, 16, 3, 4), reps=10)
    paths = {}
    for n in (64, 100, 230, 250, 500, 1000):
        a = torch.randn(n, 2 * n, generator=gen, dtype=torch.float64)
        t = (a @ a.T / (2 * n) + 1e-2 * torch.eye(n, dtype=torch.float64)).float().to(dev)
        c = torch.randn(n, generator=gen).to(dev)
        times[f"B21 S={n}"] = _cuda_ms(lambda: sr_cg.sr_cg_solve(t, c, 64))
        paths[f"B21 S={n}"] = getattr(sr_cg.sr_cg_solve, "last_path", None)
        times[f"Cholesky S={n}"] = _cuda_ms(
            lambda: torch.cholesky_solve(c[:, None], torch.linalg.cholesky(t)))
    times.update({k: v for k, v in split.items() if v > 0})
    print(json.dumps({"label": args.label, "ms": times, "B21 paths": paths}))


if __name__ == "__main__":
    main()
