#!/usr/bin/env python3
"""Smoke run of cs304_tpu_torch on one NVIDIA card (built for the H100).

    python3 chip_smoke.py

Phases (each prints its own numbers; any failure exits non-zero):
  1. card     nvidia-smi name and power limit, torch's device name
  2. build    nvcc builds every kernel from csrc/ (seconds, ptxas usage)
  3. K1       emission kernel vs its plain version at the flagship's main-path
              shape, at bench.py's (N = 512 * 151) and at 503 / 5003 states
              (rtol 1e-4, atol 1e-3)
  4. K2       trellis pair vs viterbi_composite_batch_fast on identical log_b:
              scores and full paths exactly equal (flagship B=512, 503 and
              5003 states, B=5 with T=1, integer-valued log_b for ties)
  5. main     ContinuousDecoder(emissions="quad", device="cuda") on 512
              synthetic 1.5 s clips: predict_signal_batch + predict_batch;
              every kernel launched, transcripts equal to the plain path's
  6. timing   per-kernel and end-to-end times, kernel path vs plain path
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Needs torch with CUDA, nvcc, one card.
"""
import json
import subprocess
import time

import numpy as np
import torch

RTOL_K1, ATOL_K1 = 1e-4, 1e-3  # as tests/test_pallas_emission.py holds K1
BATCH, SECONDS = 512, 1.5


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def cuda_ms(fn, reps=20):
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def random_composite(num_words, seed):
    """num_words 5-state words + a 3-state silence, flagship-like Gaussians."""
    from cs304_tpu_torch.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a

    rng = np.random.default_rng(seed)
    models = []
    for i in range(num_words + 1):
        s = 3 if i == num_words else 5
        a = rng.normal(size=(s, 39, 8)).astype(np.float32) * 0.1
        models.append(WordHMM(
            label="S" if i == num_words else f"w{i}",
            means=rng.normal(size=(s, 39)).astype(np.float32),
            covariances=a @ np.transpose(a, (0, 2, 1)) + 0.5 * np.eye(39, dtype=np.float32),
            log_a=uniform_forward_log_a(s)))
    return stack_word_models(models, penalty=-100.0)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a card")
    from cs304_tpu_torch.data.batching import make_signals
    from cs304_tpu_torch.device import fp32_exact
    from cs304_tpu_torch.models.decoder import ContinuousDecoder
    from cs304_tpu_torch.models.hmm import flagship_composite, flagship_models
    from cs304_tpu_torch.ops.cuda import _build
    from cs304_tpu_torch.ops.cuda import emission as em
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.gaussian import make_gaussian_quad_params
    from cs304_tpu_torch.ops.mfcc import mfcc_features_batch
    from cs304_tpu_torch.ops.viterbi import (
        backtrace_batch,
        first_max,
        forward_fast,
        pack_coefs,
        viterbi_composite_batch_fast,
    )
    from cs304_tpu_torch.ops.words import ids_to_strings, words_from_paths

    dev = torch.device("cuda", 0)
    fp32_exact()

    # -- 1. card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    log("card", torch_name=repr(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    lib_path = _build.library_path()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}", library=lib_path.name)
    ptxas = lib_path.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "Used" in line or "Compiling entry" in line:
                print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # Main-path inputs: the flagship and its features at the shapes
    # predict_signal_batch gives the kernels (1.5 s clips in a 2 s bucket).
    comp = flagship_composite()
    s = comp.num_states
    signals = make_signals(BATCH, SECONDS)
    bucket = 32000
    sig_pad = np.zeros((BATCH, bucket), np.float32)
    sig_pad[:, : signals.shape[1]] = signals
    sig_dev = torch.as_tensor(sig_pad, device=dev)
    ns_dev = torch.full((BATCH,), signals.shape[1], dtype=torch.int32, device=dev)
    feats, n_frames = mfcc_features_batch(sig_dev, ns_dev)
    b, t_total, d = feats.shape
    frames = feats.reshape(b * t_total, d).contiguous()

    # -- 3. K1 vs plain -----------------------------------------------------
    def k1_check(name, composite, frames_in):
        s_k = composite.num_states
        s_pad = -(-s_k // 128) * 128
        packed = em.pack_quad_params(composite.means, composite.covariances, s_pad, device=dev)
        got = em.emission(frames_in, *packed, num_states=s_k, s_pad=s_pad)
        want = em.emission_plain(frames_in, *packed)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        pad_zero = bool((got[:, s_k:] == 0).all().item())
        ok = torch.allclose(got, want, rtol=RTOL_K1, atol=ATOL_K1)
        log("K1", case=name, N=frames_in.shape[0], S=s_k, s_pad=s_pad,
            max_abs_err=err, pad_zero=pad_zero, ok=ok)
        if not (ok and pad_zero and torch.isfinite(got).all().item()):
            raise SystemExit(f"K1 disagrees with its plain version ({name})")
        return got, err

    log_b_flag, k1_err = k1_check("flagship", comp, frames)
    # bench.py's shape: the same clips unpadded, N = 512 * 151 frames.
    feats_bench, _ = mfcc_features_batch(torch.as_tensor(signals, device=dev), ns_dev)
    k1_err = max(k1_err, k1_check("bench-shape", comp, feats_bench.reshape(-1, d))[1])
    k1_err = max(k1_err, k1_check("503-states", random_composite(100, 1),
                                  frames[: 64 * t_total])[1])
    k1_err = max(k1_err, k1_check("5003-states", random_composite(1000, 2),
                                  frames[: 8 * t_total])[1])

    # -- 4. K2 vs plain -----------------------------------------------------
    k2_err = 0.0

    def k2_check(name, composite, log_b, lengths):
        nonlocal k2_err
        coefs = pack_coefs(composite.log_a, composite.lower_of_state,
                           composite.is_entry, composite.is_exit, device=dev)
        got_s, got_p = tsf.scanfree_decode(log_b, coefs, composite.penalty, lengths)
        want_s, want_p = viterbi_composite_batch_fast(
            log_b[..., : composite.num_states].contiguous(), composite.log_a,
            composite.lower_of_state, composite.is_entry, composite.is_exit,
            composite.penalty, lengths)
        torch.cuda.synchronize()
        same_s = torch.equal(got_s, want_s)
        same_p = torch.equal(got_p, want_p)
        both = torch.isfinite(got_s) & torch.isfinite(want_s)
        err = (got_s - want_s)[both].abs().max().item() if both.any() else 0.0
        k2_err = max(k2_err, err)
        log("K2", case=name, B=log_b.shape[0], T=log_b.shape[1],
            S=composite.num_states, scores_equal=same_s, paths_equal=same_p,
            max_abs_err=err, neg_inf_scores=int((~torch.isfinite(got_s)).sum()))
        if not (same_s and same_p):
            raise SystemExit(f"K2 disagrees with viterbi_composite_batch_fast ({name})")

    gen = torch.Generator(device=dev).manual_seed(0)
    rand_len = torch.randint(1, t_total + 1, (BATCH,), generator=gen, device=dev,
                             dtype=torch.int32)
    k2_check("flagship-emissions", comp, log_b_flag.reshape(b, t_total, -1), rand_len)
    for words, nb in ((100, 16), (1000, 8)):
        c_k = random_composite(words, 3)
        lb = 3 * torch.randn((nb, t_total, c_k.num_states), generator=gen, device=dev)
        ln = torch.randint(1, t_total + 1, (nb,), generator=gen, device=dev, dtype=torch.int32)
        k2_check(f"{c_k.num_states}-states", c_k, lb, ln)
    lb1 = torch.randn((5, 1, s), generator=gen, device=dev)
    k2_check("B5-T1", comp, lb1, torch.ones(5, dtype=torch.int32, device=dev))
    lbi = torch.randint(-3, 1, (64, 40, s), generator=gen, device=dev).to(torch.float32)
    k2_check("integer-ties", comp, lbi,
             torch.randint(1, 41, (64,), generator=gen, device=dev, dtype=torch.int32))

    # -- 5. main path -------------------------------------------------------
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                            device="cuda")
    if dec.backend != "scanfree":
        raise SystemExit(f"backend 'auto' resolved to {dec.backend!r} on CUDA")
    # The same features predict_signal_batch computes, as a ragged list.
    feat_list = [f[:n].cpu().numpy() for f, n in zip(feats, n_frames.tolist())]
    counters = (em.emission, tsf.trellis_forward, tsf.trellis_backtrace)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    texts_sig = dec.predict_signal_batch(list(signals))
    texts_feat = dec.predict_batch(feat_list)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    log("main", launches=json.dumps(launches), distinct_transcripts=len(set(texts_sig)),
        sample=repr(texts_sig[:4]))
    if not all(n > 0 for n in launches.values()):
        raise SystemExit(f"a kernel of the main path never launched: {launches}")

    qp = make_gaussian_quad_params(comp.means, comp.covariances, device=dev)
    lowers = torch.as_tensor(comp.lowers, device=dev)
    uppers = torch.as_tensor(comp.uppers, device=dev)
    sil = comp.labels.index("S")

    def plain_path(sig, ns):
        f, nf = mfcc_features_batch(sig, ns)
        log_b = em.gaussian_log_pdf_quad_plain(qp, f)
        sc, paths = viterbi_composite_batch_fast(
            log_b, comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
            comp.penalty, nf)
        ids, counts = words_from_paths(paths, nf, None, lowers, uppers, sil, max_words=64)
        return sc, ids, counts

    sc_p, ids_p, counts_p = plain_path(sig_dev, ns_dev)
    texts_plain = ids_to_strings(ids_p.cpu().numpy(), counts_p.cpu().numpy(), comp.labels)
    sc_k, _, _ = dec.decode_signals(sig_dev, ns_dev)
    score_err = (sc_k - sc_p).abs().max().item()
    finite = bool(torch.isfinite(sc_k).all().item())
    log("main", transcripts_equal_plain=texts_sig == texts_plain,
        predict_batch_equal=texts_feat == texts_sig, scores_finite=finite,
        max_abs_score_err=score_err, B=len(texts_sig))
    if not (texts_sig == texts_plain and texts_feat == texts_sig and finite):
        raise SystemExit("main path transcripts differ from the plain path's")

    # -- 6. timing ----------------------------------------------------------
    def window(fn):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(20):
                out = fn()
            torch.cuda.synchronize()
            [o.cpu() for o in out]
            best = min(best, time.perf_counter() - t0)
        return best / 20 * 1e3

    kernel_fn = lambda: dec.decode_signals(sig_dev, ns_dev)  # noqa: E731
    plain_fn = lambda: plain_path(sig_dev, ns_dev)  # noqa: E731
    kernel_fn(), plain_fn()
    t_plain1, t_kern1 = window(plain_fn), window(kernel_fn)
    t_kern2, t_plain2 = window(kernel_fn), window(plain_fn)
    t_kern, t_plain = min(t_kern1, t_kern2), min(t_plain1, t_plain2)
    log("timing", path="kernels", ms_per_batch=t_kern, utt_per_s=BATCH / t_kern * 1e3)
    log("timing", path="plain", ms_per_batch=t_plain, utt_per_s=BATCH / t_plain * 1e3)

    packed = dec._quad
    log_b_main = em.emission(frames, *packed, num_states=s, s_pad=dec._s_pad)
    lb3 = log_b_main.reshape(b, t_total, -1)
    coefs = dec._coefs
    alpha, bp = tsf.trellis_forward(lb3, coefs, comp.penalty, n_frames)
    _, best = first_max(alpha, coefs[5] > 0)
    timings = {
        "emission": (cuda_ms(lambda: em.emission(frames, *packed, num_states=s, s_pad=dec._s_pad)),
                     cuda_ms(lambda: em.emission_plain(frames, *packed))),
        "trellis_forward": (cuda_ms(lambda: tsf.trellis_forward(lb3, coefs, comp.penalty, n_frames)),
                            cuda_ms(lambda: forward_fast(lb3, coefs, comp.penalty, n_frames), reps=3)),
        "trellis_backtrace": (cuda_ms(lambda: tsf.trellis_backtrace(bp, best, n_frames)),
                              cuda_ms(lambda: backtrace_batch(bp, best, n_frames), reps=3)),
    }
    for name, (ms, plain_ms) in timings.items():
        log("timing", kernel=name, ms=ms, plain_ms=plain_ms,
            shape=f"B={b} T={t_total} S={s}")

    meta = {
        "emission": ("cs304_tpu_torch/csrc/emission.cu",
                     "cs304_tpu/ops/pallas/emission.py:82", k1_err),
        "trellis_forward": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                            "cs304_tpu/ops/pallas/trellis_scanfree.py:55", k2_err),
        "trellis_backtrace": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                              "cs304_tpu/ops/pallas/trellis_scanfree.py:121", k2_err),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err,
         "ms": timings[name][0], "plain_ms": timings[name][1]}
        for name, (src, rep, err) in meta.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
