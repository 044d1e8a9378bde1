#!/usr/bin/env python3
"""Smoke run of cs304_tpu_torch on one NVIDIA card (built for the H100).

    python3 chip_smoke.py

Phases (each prints its own numbers; any failure exits non-zero):
  1. card     nvidia-smi name and power limit, torch's device name
  2. build    nvcc builds every kernel from csrc/ (seconds, ptxas registers
              and spills; one line of registers, stack and spill bytes for
              each LM instantiation of the team kernel)
  3. K1       emission kernel (on the folded operand) vs its plain version at
              the flagship's main-path shape, at bench.py's (N = 512 * 151),
              at the K=2 GMM width (S*K = 116 columns), at 503 / 5003
              states, and at the edges: s_pad = S = 58 (the
              gaussian_log_pdf_quad call), N = 1, N off the frame tile,
              D = 1, D = 64 at 58 and at 503 states (rtol 1e-4, atol 1e-3)
  4. K2       the scan-free trellis on identical log_b: the decode-mode
              kernel vs viterbi_composite_batch_fast (scores and full paths),
              the backpointer-mode forward vs forward_fast (alpha and bp), K2-bt
              vs backtrace_batch, all exactly equal (flagship B=512 at ld=128
              and at ld=S=58 with length-1 rows, 98, 503 and 5003 states, B=5
              with T=1, integer-valued log_b for ties, T=1280, T=4000, 503
              states at T=500); each case logs whether the decode kernel kept
              its codes in shared memory or a global scratch, and fails if
              that is not the branch the case is meant to drive (global at
              5003 states, T=4000 and 503 states at T=500)
  5. main     ContinuousDecoder(emissions="quad", device="cuda") on 512
              synthetic 1.5 s clips: predict_signal_batch + predict_batch;
              the emission and decode kernels launched and no other trellis
              kernel, transcripts equal to the plain path's
  6. timing   per-kernel and end-to-end times, kernel path vs plain path; the
              decode kernel against the chain it replaced (trellis_forward +
              first_max + trellis_backtrace), and µs per step of both forward
              modes
  7. K3       the sentence topology of the scan-free team kernel vs its
              plain versions: the decode mode (one launch) vs
              _banded_trellis_batch (scores and full paths), the backpointer
              mode vs banded_sentence_forward (alpha and bp), all exactly
              equal (the trainer's shape B=896, T=160, S=59 on real gathered
              emissions; -inf sprinkling, integer ties, a degenerate entry,
              length-0 rows, B=5 with T=1, S=503, S=2100, T=4000); each logs
              its codes branch and fails off it (global at T=4000)
  8. train    ContinuousTrainer(device="cuda") at full width (12 labels,
              D=39, 896 utterances of <= 150 frames) for 3 iterations with
              the K3 decode mode and again with the plain trellis: equal
              parameters and iteration counts, the decode mode launched and
              neither the backpointer mode nor K2-bt; ms per iteration and
              its split by stage
  9. pipeline synthetic corpus -> endpointing -> MFCC on the card ->
              batched k-means boot + silence model -> 4 embedded iterations
              -> ContinuousDecoder: exact-sequence accuracy >= 0.85 on the
              training speakers (the JAX package's own bar)
 10. timing   K3's decode and backpointer modes and K2-bt vs their plain
              versions at the trainer's shape, and the chain the decode mode
              replaced (backpointer mode + gather + K2-bt)
 11. K1-split the split emission kernel ("high": 3 bf16 wgmma passes,
              "default": 1) vs its plain version at phase 3's shapes but
              s_pad = 58, which it does not take (rtol 1e-4, atol 1e-3, zeros
              past S), each tier's max |delta| against K1; x2_mode "selmm"
              bitwise "concat"
 12. K4       dense trellis vs dense_forward: alpha (signs of zero too),
              backpointers, scores and paths exactly equal (flagship
              emissions B=512, with length-0 and -1 rows, 503 states,
              integer ties, B=5 with T=1, -inf sprinkled in trans at 58, 220,
              300, 503 and 1000 states, B not a multiple of the utterances a
              block or cluster carries, signed zeros); each case logs its
              branch (block, cluster, streamed) and fails off it
 13. K5/K6    the fast / lanes wrappers bitwise forward_fast at S=58 (the
              backpointer-mode forward's launches)
 14. decode   ContinuousDecoder(backend="pallas") on the 512 clips: K1, K4
              and K2-bt launched, transcripts equal to backend="scan"'s;
              agreement with the scan-free path; the "high" and "default"
              tiers launch the split kernel, agreement with "highest"
 15. tiers    the phase-9 models decoded with emissions="quad" at each tier:
              exact-sequence accuracy and agreement with "highest"; "high"
              >= 0.85 on the training speakers
 16. timing   the emission kernels at 58, 116 (S*K), 503 and 5003 states and
              K4 (58 and 503 states; 1000 logged) vs their plain versions,
              every kernel's library call (the emission kernels': one GEMM
              on a materialized x2 and one on x2's symmetric half, the
              faster kept; FP32 for "highest" and "high", whose accuracy
              only it reaches, bf16 for "default", logged beside "high")
              and bound (folded count, the unfolded one beside it); each
              emission kernel's stage split (timing variants: K1 with a
              constant x2; the split kernel's A build alone, wgmmas alone,
              without the linear rows, frames in and emissions out alone);
              end-to-end ms per batch of the
              scan-free, pallas, high and pallas+high paths
 17. stream   the stream mode of the scan-free team kernel (the serving
              pool's banded step) bitwise _advance_compact on CPU copies
              (alpha with its signs of zero, the ring): 58 states with the
              int8 ring, 373, 503 and 5003 with int32, staggered starts,
              chunks of 1-32 frames, idle and recycled slots, compact and
              dense rows, a zero penalty, integer ties; the dense step
              through K4 bitwise _advance; K2-bt on int8 and int32 ring
              slices bitwise backtrace_batch; device times at
              streaming_bench.py's shapes (128 / 512 / 1024 slots, chunk 16,
              58 states), 256 slots at 503 and 64 at 5003, each with its
              bound, µs a step and its build's registers and spill bytes
              (phase 2 logs every stream and beam instantiation's); whole
              banded pools on the card at 58 and 503 states give
              the CPU pools' texts and launch the stream mode and K2-bt;
              real-time streams of both step_impls, and a torch.profiler
              trace of one pool step of each
 18. serving  ServingSessionPool(device="cuda") on phase 9's models with
              serving_bench.py's traffic (64 sessions of 3 s, 100 ms feeds,
              64 slots, chunk 32, max_frames 4096): every final equals
              ContinuousDecoder.predict_signal_batch on its endpointed signal
              (reference per-frame endpointing), 4 sessions' finals and
              last partials equal a device="cpu" run (partials >= 95%), K4,
              K2-bt and scanfree_decode launched and no plain step on a CUDA
              tensor; real-time sessions, ms per feed() round, HAS_NATIVE,
              a torch.profiler trace (the card's busy share) and a cProfile
              of feed() rounds (host functions)
 19. FB       the Baum-Welch sentence forward-backward kernel vs
              banded_fb_plain, and its E-step mode (gamma, xi sums, ll)
              vs banded_fb_posteriors_plain (the trainer's shape B=896,
              T=160, S=59 on real gathered emissions; -inf sprinkled in
              log_b and c1/c2, length-0 and -1 rows, B=5 with T=1, S=98,
              S=503 at T=340, S=2100 at T=1500, T=4000; finals the band
              reaches, each case failing unless half its rows have a finite
              ll, row 0 reaches its final and gamma / xi keep their sums):
              every cell of both modes bitwise (where not, the cells
              within 1e-5 * max(1, |x|) and which side's exp rounds exp(e)
              correctly are logged before it fails); device time, plain
              time, bound, µs per step by slope (the E-step's forward alone
              timed on utterances whose final state lies outside the
              trellis, which skip the backward)
 20. BW       ContinuousTrainer(update="baum_welch") at phase 8's width for
              3 iterations with the E-step kernel and with the plain E-step:
              equal iteration counts, parameters within rtol 1e-4 /
              atol 1e-5, the E-step kernel launched once an iteration, FB's
              alpha/beta mode never, no plain forward-backward or E-step on
              a CUDA tensor; the E-step call allocating nothing of gamma's
              size besides gamma (no (B, T, S) alpha or beta); ms per
              iteration and its split by stage
 21. GMM      phase 9's models: 3 Baum-Welch iterations (accuracy >= 0.85);
              promote_to_gmm(K=2) + GMMContinuousTrainer for 4 iterations
              with K3 and with the plain trellis (bitwise, K3 launched), ms
              per iteration; ContinuousDecoder on the GMMs: whitening
              accuracy >= 0.85, emissions="quad" at each tier launching K1
              or the split kernel over S*K columns (agreement reported),
              predict_signal_batch == predict_batch on the same clips, a
              GMM checkpoint round trip decoding the same texts; GMM pools
              on the card (dense at 58 states, and banded) == CPU pools
 22. search   the LM and BEAM decode modes and the LM stream mode of the
              scan-free team kernel against their plain versions, bitwise
              in scores, paths and score signs (ring rows, alpha and its
              signs for the stream mode): the flagship on phase 6's
              emissions with a bigram trained on seeded digit strings,
              equal pair values on integer ties, zero pair values, 503
              states (W = 101), 5003 states (W = 1001, codes and sources in
              the global scratch), beams of 50 and 5 (the share of final
              states pruned logged), LM + beam; 512 slots x 16 frames at 58
              states and 256 at 503 for the stream mode. Each case fails
              unless half its rows are finite; each LM case logs its pair
              table's branch and fails off it (registers at the flagship in
              both modes, shared memory for the decode mode at 503 states,
              global at 5003 states and for the 503-state stream).
              ContinuousDecoder(bigram=) and
              (beam=) on the 512 clips: transcripts equal to a device="cpu"
              decoder's, their mode launched, no plain trellis on the card,
              ms a batch; on phase 9's models the bigram decode's accuracy
              >= 0.85, and the ms and launches of predict_batch_with_confidence
              (K4 + K2-bt and LSUM) at 64 clips, predict_nbest (KBEST) and
              forward_lattice(posteriors=True) (LMAX and LSUM) on one clip,
              counted, duration and grammar decodes at 64 clips (on the
              PLANES / DURATION kernels, their transcripts equal to a
              device="cpu" decoder's), each with its kernels launched and
              no plain constrained, posterior or n-best loop on a CUDA
              tensor; phase 18's traffic under
              ServingSessionPool(bigram=) and (confidences=True), 16 sessions
              on the card equal to a CPU pool's (the bigram pool's first 4;
              every confidence pool's session, confidences within 1e-4,
              or log-confidences within CONF_ULPS float32 ulps of the
              final's |log Z|, capped at 4e-3; |log Z| and the ratio logged),
              the LM stream mode launched; each new mode's time, plain time
              and bound, and every LM shape (decode with and without a beam
              at the flagship, 503 and 5003 states, stream at 58, 503 and
              5003) beside the flat mode's time at the same inputs (the beam
              decode's for LM + beam), with its bound and table branch; the
              BEAM decode at 503 and 5003 states beside the flat mode, with
              its bound
 23. words    the banded word trellis (ops/viterbi.viterbi_banded_batch)
              on K3 bitwise its plain version (scores on every row, paths
              on every finite row), with the quirk (one decode launch) and
              without (the backpointer mode + K2-bt): the k-means shape
              (12 models x 64 utterances at S=5, per-row log_a), S=59 at
              T=1 and with length-0 rows, S=1 and 2; phase 9's batched
              k-means boot timed on K3 and on the plain trellis (a note);
              ModelCollection on the flagship's 11 digit models over phase
              5's 512 clips (5,632 K3 rows in one launch): labels equal to
              the CPU port's, batch ms
 24. align    ForcedAligner on phase 9's models, card against CPU: segments
              equal, scores within 1e-4 relative, one K3 launch a
              transcript; one fused=False iteration (Viterbi, Baum-Welch) at
              phase 8's corpus against the fused one (atol 2e-5 / 5e-5,
              rtol 1e-4); map_adapt means card against CPU within 1e-4;
              viterbi_composite_assoc against the sequential dense decode
              (rtol 1e-4 / atol 1e-3, paths equal); the legacy Baum-Welch
              pass launching FBD once a transcript
 25. DTW      the column kernel (csrc/dtw.cu) bitwise dtw_columns_plain with
              and without pruning: the 11 digits' templates from phase 9's
              corpus (4 takes each, H ~ 1,100) against a digit and against
              the longest pipeline sentence (L ~ 200), 4,000 to 8,192 rows,
              12,000 (past the earlier 8,192-row cap), 18,000 and 20,000
              (the 64-rows-a-lane tier with a ring of 3 and of 2 columns)
              and 32,768 (the cap),
              L = 1, one-frame words, and a zero-distance sample (integer
              features, a word's own frames: cost exactly 0, a zero prune
              threshold); DTWRecognizer.search on the card equal to the CPU
              port's, its launches counted (the main path), and again at
              11 words x 10 templates of 80-100 frames (H ~ 9,900); a
              search's host wall split into upload, distances, kernel and
              readback; device time, plain time, bound and µs a column
              beside the serial floor recorded in PERF.md (a constant from
              the redesign's step 0, not measured in this run)
 26. MFCC     precision "high" and "default" features within their stated
              bounds of "highest" on phase 5's clips (high max 1e-2;
              default mean 0.25, max 2.0); transcripts against highest's
              (the flagship on the 512 clips, phase 9's models on its
              evaluation clips, with accuracy): "high" must agree 1.0
 27. phones   benchmarks/phone_tier.py's default configuration (30 words
              of 3-5 phones, the last 3 held out as OOV, 4 + 2 speakers,
              3 takes, 12 training sentences, 10 iterations, cov_reg 0.1,
              penalty -100, seed 5) with every tier: the word tier, the
              monophones, biphones, triphones, tied triphones (4 a phone),
              senones (4 leaves a state) and a K=2 GMM phone tier, trained
              on the card; the last fused K3 launch of the phone and the
              tied senone tier bitwise the plain trellis on CPU copies of
              its inputs; the phone tier trained again on the CPU, the
              card's parameters within rtol 1e-4 / atol 1e-5 of it; one
              tied iteration and the tie pooling timed; every lexicon word
              composed and decoded with the default emissions="whiten"
              (the benchmark's) and with "quad" (K1) on the in-vocab and
              OOV sentences (and the senone tier's tree-synthesis
              ablation); the benchmark's gates for both (phone tier >=
              0.85 in-vocab, OOV exact >= 0.3, each context-dependent tier
              >= 0.85); 8 in-vocab + 8 OOV clips of every tier and form
              equal to the CPU port's; tied senone slots and transitions
              bitwise shared, a second senone training bitwise the first;
              K3 launched in every training, K2 in every decode and K1 in
              every quad decode, no plain trellis or plain emission on a
              CUDA tensor; one line a tier and form (train s, iterations,
              params, composite states, decode ms a batch, accuracies)
              with the card's name and power limit
 28. CLI      the README's Quickstart chain through the port's scripts'
              main(argv), in process, on the synthetic corpus (no --device:
              the card): project3_train, project5_train_no_empty,
              project6_train (Viterbi with --state-dir, Baum-Welch, K=2
              GMM), project5_test_ndigits (--csv-out, --bigram-lm),
              transcribe (plain, --fast, --confidence --timings (LSUM
              launched), --beam, --known-count, --grammar-strings,
              --min-duration (PLANES / DURATION launched, no K2-bt),
              --device cpu), align, adapt_speaker, project6_interactive
              (--nbest --confidence --spot --lattice-dot: KBEST, LSUM and
              LMAX launched), train_phones,
              demo_serving (project3_predict and the penalty sweep where
              matplotlib is installed; their classifier checked either way);
              project3_train --gmm-mixtures 4 --baum-welch (one
              iteration of each trainer) on the card (K3 and one FBD launch
              a word) and with --device cpu (no card kernel), the models
              within tests/test_torch_cli_train_gmm.py's bound (BW_BOUND),
              and project6_interactive --rescore-lm (LMAX, and K3 for the
              arc scores);
              n-digit CSV accuracy >= 0.9, align 3 7 5, transcripts equal to
              the decoder's, project6_train bitwise the trainer's, the CPU
              run equal and off the card, each script's kernels launched,
              no plain version on the card; one [cli] line a script
 29. DP       data parallelism (parallel/data_parallel.py): a 1-rank NCCL
              group from make_mesh(); the Viterbi, Baum-Welch and K=2 GMM
              trainers over it on phase 8's corpus bitwise the
              single-device trainers, with the same K3 / E-step launches;
              dp_composite_decode at the flagship (B=512) bitwise K4 +
              K2-bt on the same log_b and launching them; a
              ServingSessionPool(mesh=) on phase 18's traffic equal to the
              pool without a mesh; the Viterbi iteration's ms with and
              without the mesh and the collectives' ms an iteration; then
              two spawned gloo ranks on cuda:0, Viterbi (3 iterations) and
              Baum-Welch (1 and 3) over the 2-rank mesh: ranks bitwise equal,
              within rtol 1e-4 / atol 2e-5 of the single-device trainer (3
              Baum-Welch iterations logged beside one device's spread under
              another chunking, and each of the three held to the bound from
              the single device's models after the one before), K3
              and the E-step launched (gloo gathering the CUDA tensors);
              no plain version on a CUDA tensor; every group destroyed
              before the report
 30. constr.  the constrained searches' kernels (csrc/trellis_constrained.cu)
              against their plain versions through the ops' dispatchers,
              first on the main path's inputs (the emissions phase 22's
              counted, menu-grammar and duration decodes of 64 clips hand
              them), then PLANES (counted decoding N = 1..7 and a count range, the
              6-string menu grammar) and DURATION (min 2; min 3 / max 6 a
              word) at the flagship on phase 6's emissions read at their
              row stride, integer ties, 503 states (B = 16, T = 201; N <= 4,
              a 3-position grammar, min 3 / max 6 and max 8) and 5003 states
              (B = 2, T = 60; N = 2, min 2, min 3 / max 6 and max 8); the
              edges B = 1, T = 1, length-0 rows and a cluster of two CTAs;
              the simple branch past the teams (65 and 501 planes, D = 9 at
              503 and 5003 states), walked by K2-bt and, past its widest
              row, by the forward; ragged lengths and a length-1 row with
              no admissible path; scores bitwise with their signs, paths on
              every finite row; each case's branch (team, cluster, simple),
              walk and launches; device time of each kernel (CUDA-graph
              replays on tables built once) in turns beside the simple
              branch's (the PR-19 kernel), its plain loop's eager time, its
              bound, µs a step and ptxas' registers and spills. (Phase 22
              runs them on phase 9's 64 clips: transcripts equal to a
              device="cpu" decoder's, PLANES / DURATION launched and no
              K2-bt, no plain constrained trellis on the card.)
 31. lattice  the posterior and n-best searches' kernels
              (csrc/trellis_lattice.cu) against their plain versions through
              their dispatchers: LSUM (the sum-semiring passes: the same
              -inf cells, the rest within LSUM_REL * max(1, |x|)), LMAX (the
              max-plus lattice passes) and KBEST (the k-best forward)
              bitwise, every row included; first on the main path's inputs
              (phase 22's 64 clips, 128-padded and scored in one call; its
              first clip for LMAX and for KBEST at K = 8), then the flagship
              on phase 6's emissions (B = 64, T = 201; K = 6, 8, 16), 375
              and 503 states (B = 16, T = 201), 5003 states (B = 2, T = 60;
              KBEST past 32 exit rows on its simple branch, the first
              design, its rows in a device scratch at K = 8 and 16); the
              edges: single-state words under a -25 and a 0 penalty,
              length-2 rows, integer ties, K = 1 / 2 / 4 / 6 / 16 / 32 / 33
              (every bucket of KBEST's team branch and one past it), T = 1,
              each LSUM / KBEST case logging its branch; each kernel's
              device time beside its plain loop's eager time, its bound, µs
              a step and ptxas' registers and spills, LSUM and KBEST in
              turns p n n p beside the first design (simple=True) with the
              skeleton's µs a step (the step's barriers and shared
              exchanges alone)
 32. slice 10 FBD, the dense forward-backward (csrc/forward_backward.cu),
              against its plain version in its forward, backward and
              posteriors modes, one launch each, every output bitwise
              (where gamma or xi is not: W5's measure and a probe of
              which side's xi sums the correctly rounded exp terms,
              logged before failing; FBD's expf against torch.exp on
              4,096 subnormal results and 2^20 values in [-103.9,
              -17.5] logged): the word shape (B=256, T=128,
              S=5, a uniform upper-triangular log_a, no final), its banded
              matrix with a pinned final, S=1, S=2 at T=1, an all -inf
              column, S=128 (the cap), lengths 0, 1 and past T, a learned
              matrix (scattered -inf entries, a dead row and column) at
              S=5 and 32, banded S=16 and 100 with a pinned final, T=600,
              kernel_ab.py's seeded word call (every build of the plan), the
              legacy trainer's largest call (one fused=False Baum-Welch
              iteration at phase 8's corpus, pinned final), and each word's
              own Baum-Welch call (its clips, GMM emissions and learned
              log_a, captured from one iteration); each mode's device time
              at the word shape, the posteriors' at the seeded word call,
              the legacy call and the largest word call (the kernels
              line's row), beside its plain loop's eager time, bound
              (counted over log_a's finite entries), µs a chain step, the
              skeleton's µs a step (its build's chain cut to the exchange)
              and ptxas' registers and spills;
              isolated-word Baum-Welch at full width (the slice's main
              path: train_gmm_hmm_baum_welch, K = 4, phase 9's 11 words, all
              of a word's clips in one batch, from k-means models trained
              on the card): one FBD launch an iteration, no plain loop on
              the card, the parameters within BW_BOUND of a CPU run from the
              same models; an iteration's wall and project3_train
              --gmm-mixtures 4 --baum-welch's, with FBD and with the plain
              loop on the card, in turns; lattice_rescore on phase 22's clip
              0 (a bigram of the pipeline's transcripts): arc scores
              bitwise the CPU's, one K3 launch for all arcs a call, the same
              best path; viterbi_composite_assoc on 4 clips: one K2-bt
              launch a decode, paths equal to the sequential decode's and
              the CPU's
Every check of a kernel against its plain version runs on poisoned memory
(kernel_runs / plain_run): the wrapper is called once under each of two fill
patterns of what torch.empty returns (NaN / -12345 / 0xFF, then 0x7F7F7F7F /
0x5A5A5A5A / 0xA5), whose results must agree in every bit, and the plain
version under a third (0xC3 bytes), so a cell the kernel leaves unwritten
differs whatever the plain version holds there; the pool steps' ring rows are
poisoned likewise before each step.
Kernel and library times are device times from CUDA-graph replays
(device_ms); plain versions run eagerly (cuda_ms), host loops included.
The line before the last is the kernels' JSON record (twenty-one kernels, each with
launches, max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms and the
poisons its check ran under, "poisons": ["nan", "fill"]); the
last line is
{"ok": true, "device": {...}}. Needs torch with CUDA, nvcc, one card.
"""
import contextlib
import json
import re
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

RTOL_K1, ATOL_K1 = 1e-4, 1e-3  # as tests/test_pallas_emission.py holds K1
# Published H100 SXM peaks (NVIDIA data sheet).
PEAK_FP32, PEAK_BF16, HBM_BYTES_PER_S = 67e12, 989e12, 3.35e12
# A max-plus add or compare is one FP32 instruction, not an FMA (which the
# FP32 peak counts as two operations): half the peak's operation rate.
PEAK_FP32_ALU = PEAK_FP32 / 2
BATCH, SECONDS = 512, 1.5
# The embedded trainer's corpus: benchmarks/train_bench.py's shape.
TRAIN_TRANSCRIPTS = ["14", "27Z", "4Z2Z", "58361", "9O4738", "14Z9O72", "6O3"]
UTTS_PER_TRANSCRIPT, MAX_FRAMES = 128, 150
# The pipeline of phase 9 (tests/conftest.py's trained_system).
PIPELINE_TRANSCRIPTS = ["12", "4Z", "375", "9O2", "186Z", "54321"]
ACC_BAR = 0.85  # tests/test_continuous_pipeline.py, training speakers
# Serving confidences, card against CPU: log-confidences within CONF_ULPS
# float32 ulps of the final's |log Z| (phase 22), never wider than the
# CONF_LOG_CAP the gate had before |log Z| was measured.
CONF_ULPS, CONF_LOG_CAP = 4, 4e-3
# log of float32's smallest normal number (1.18e-38) and of its smallest
# subnormal (2^-149 = 1.4e-45).
LOG_FLT_MIN = float(np.log(np.finfo(np.float32).tiny))
LOG_SUBNORMAL_MIN = -149 * float(np.log(2.0))


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def guard(plain_on_card, mod, name):
    """Replace mod.name (a plain version) by a wrapper that counts, in
    plain_on_card[name], its calls with a CUDA tensor among the positional
    arguments; returns (mod, name, the original) to restore it."""
    fn = getattr(mod, name)

    def counted(*args, **kwargs):
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            plain_on_card[name] = plain_on_card.get(name, 0) + 1
        return fn(*args, **kwargs)
    setattr(mod, name, counted)
    return mod, name, fn


# Poisoned allocations, as tests/torch_poison.py (this script does not
# import tests/): inside poisoned(pattern) torch.empty, torch.empty_like and
# Tensor.new_empty return memory already filled with the pattern. A check
# calls a kernel's wrapper once under each of KERNEL_POISONS (kernel_runs:
# the two results must agree in every bit) and its plain version under
# PLAIN_POISON (plain_run). POISONED: kernel row name -> the patterns its
# checks ran under (the kernels line's "poisons").
KERNEL_POISONS = ("nan", "fill")
PLAIN_POISON = "plain"
_POISON_BYTES = {"fill": (0x7F, 0x5A, 0xA5), "plain": (0xC3, 0xC3, 0xC3)}
POISONED = {}


def poison_value(dtype, pattern):
    """The scalar every cell of a dtype tensor holds under pattern: "nan"
    NaN / -12345 / 0xFF (uint8) / -128 (int8), else the pattern's byte in
    every byte (floats, wider integers, one-byte integers)."""
    if dtype == torch.bool:
        return pattern != "fill"
    one_byte = dtype.itemsize == 1
    if pattern == "nan":
        if dtype.is_floating_point:
            return float("nan")
        return (0xFF if dtype == torch.uint8 else -128) if one_byte else -12345
    f_byte, i_byte, b_byte = _POISON_BYTES[pattern]
    byte = f_byte if dtype.is_floating_point else b_byte if one_byte else i_byte
    return torch.full((dtype.itemsize,), byte, dtype=torch.uint8).view(dtype)[0].item()


def poison_(t, pattern):
    if t.numel():
        t.fill_(poison_value(t.dtype, pattern))
    return t


@contextlib.contextmanager
def poisoned(pattern):
    poison_value(torch.float32, pattern)
    empty, empty_like, new_empty = torch.empty, torch.empty_like, torch.Tensor.new_empty
    torch.empty = lambda *a, **k: poison_(empty(*a, **k), pattern)
    torch.empty_like = lambda *a, **k: poison_(empty_like(*a, **k), pattern)
    torch.Tensor.new_empty = lambda self, *a, **k: poison_(new_empty(self, *a, **k), pattern)
    try:
        yield
    finally:
        torch.empty, torch.empty_like, torch.Tensor.new_empty = empty, empty_like, new_empty


def differing_cells(a, b):
    """Cells whose bits differ between two results of one call (floats by
    their bit patterns: NaN of the same bits equal, -0.0 not +0.0)."""
    if isinstance(a, (tuple, list)):
        return sum(differing_cells(x, y) for x, y in zip(a, b, strict=True))
    if isinstance(a, np.ndarray):
        a, b = (torch.from_numpy(np.ascontiguousarray(x)) for x in (a, b))
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return max(a.numel(), b.numel(), 1)
        if a.dtype.is_floating_point:
            width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.dtype.itemsize]
            a, b = a.view(width), b.view(width)
        return int((a != b).sum())
    return int(a != b)


def kernel_runs(names, fn, *args, **kwargs):
    """fn(*args, **kwargs) once under each of KERNEL_POISONS -> the two
    results; exits where their bits differ in any cell (a cell the call
    leaves unwritten holds each run's poison). names: the kernels line's
    row(s) whose wrapper fn calls."""
    runs = []
    for pattern in KERNEL_POISONS:
        with poisoned(pattern):
            runs.append(fn(*args, **kwargs))
        for name in ([names] if isinstance(names, str) else names):
            POISONED.setdefault(name, set()).add(pattern)
    torch.cuda.synchronize()
    n = differing_cells(*runs)
    if n:
        raise SystemExit(f"{names}: {n} cells differ between the poisons "
                         f"{KERNEL_POISONS}: left unwritten")
    return runs


def plain_run(fn, *args, **kwargs):
    """fn(*args, **kwargs) under PLAIN_POISON."""
    with poisoned(PLAIN_POISON):
        return fn(*args, **kwargs)


def poison_rows(ring, slot_ids, t, valid, pattern):
    """Fill the ring rows a pool step writes (t .. t + valid - 1 of each fed
    slot, the rows past T_max landing on its last) with a poison."""
    b, t_max = ring.shape[:2]
    for slot, t0, v in zip(*(np.asarray(x).tolist() for x in (slot_ids, t, valid))):
        if v > 0 and slot < b:
            poison_(ring[slot, min(t0, t_max - 1): min(t0 + v, t_max)], pattern)


def stream_step_runs(name, step, alpha, ring, slot_ids, t, valid):
    """step(alpha, ring), a pool step in place, on a copy of the pool's state
    under each of KERNEL_POISONS, the ring rows it writes poisoned first ->
    the first copy; exits where the copies differ in any bit."""
    outs = []
    for pattern in KERNEL_POISONS:
        a, r = alpha.clone(), ring.clone()
        poison_rows(r, slot_ids, t, valid, pattern)
        with poisoned(pattern):
            step(a, r)
        outs.append((a, r))
        POISONED.setdefault(name, set()).add(pattern)
    torch.cuda.synchronize()
    n = differing_cells(*outs)
    if n:
        raise SystemExit(f"{name}: {n} cells of the pool's state differ between the "
                         f"poisons {KERNEL_POISONS}: left unwritten")
    return outs[0]


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


def device_ms(fn, reps=20):
    """Device time of one fn() (ms): reps calls captured in one CUDA graph,
    the graph replayed after a warm-up and timed with CUDA events, so the
    wrappers' host work stays outside the window (a kernel of ~20 µs can
    take less time than its Python wrapper, which then sets an eager loop's
    pace)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def window(fn):
    """Host wall ms per call of fn(): best of 3 windows of 20 calls, the
    clock stopped after a synchronize and a host copy of every output."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(20):
            out = fn()
        torch.cuda.synchronize()
        [o.cpu() for o in out]
        best = min(best, time.perf_counter() - t0)
    return best / 20 * 1e3


# The team kernel's instantiations in ptxas' mangled names:
# trellis_team_kernel<K, MODE, SENT, RingT, LM, BEAM[, WIDE]>.
TEAM_KERNEL = re.compile(r"trellis_team_kernelILi(\d)ELi(\d)ELb([01])E([ai])Lb([01])ELb([01])E"
                         r"(?:Lb([01])E)?")
TEAM_MODES = {"0": "backpointers", "1": "decode_shared", "2": "decode_global", "3": "stream"}
# Phase 2's reading of the build log, for the rows that print their build's
# spill bytes (phase 17).
BUILD_RESOURCES = []


def team_kernel_resources(ptxas_log):
    """Registers, stack frame and spill bytes of each instantiation of the
    team kernel, from nvcc's -Xptxas=-v log (one dict each)."""
    out, cur = [], None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            m = TEAM_KERNEL.search(line)
            cur = None
            if m:
                k, mode, sent, ring, lm, beam, wide = m.groups()
                cur = {"K": int(k), "mode": TEAM_MODES[mode], "sent": sent == "1",
                       "ring": {"a": "int8", "i": "int32"}[ring] if mode == "3" else None,
                       "lm": lm == "1", "beam": beam == "1", "wide": wide == "1"}
                out.append(cur)
        elif cur is not None:
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
            used = re.search(r"Used (\d+) registers", line)
            if frame:
                cur.update(stack_bytes=int(frame[1]), spill_stores=int(frame[2]),
                           spill_loads=int(frame[3]))
            if used:
                cur["registers"] = int(used[1])
    return out


def ptxas_resources(ptxas_log, pattern):
    """Registers, stack frame and spill bytes of the first entry function
    whose name matches pattern in nvcc's -Xptxas=-v log."""
    out, on = {}, False
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            if on:
                break
            on = bool(pattern.search(line))
        elif on:
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
            used = re.search(r"Used (\d+) registers", line)
            if frame:
                out.update(stack_bytes=int(frame[1]), spill_stores=int(frame[2]),
                           spill_loads=int(frame[3]))
            if used:
                out["registers"] = int(used[1])
    return out


def constrained_resources(key, tabs, t, penalty):
    """ptxas' registers and spills of the team instantiation a launch on
    tabs at T steps and penalty takes (its template arguments as the
    library's team_instance reports them), and of the simple branch's
    kernel (phase 30's timing rows)."""
    from cs304_tpu_torch.ops.cuda import _build
    from cs304_tpu_torch.ops.cuda import trellis_constrained as tcs

    path = _build.library_path().with_suffix(".log")
    text = path.read_text() if path.exists() else ""
    planes = key == "trellis_planes"
    inst = tcs.team_instance(planes, tabs, t, penalty)
    # Mangled names: planes_team_kernel<K, CLUSTERED, KEY>,
    # duration_team_kernel<K, DM, SLOTS_SMEM, TWO>; the simple branch's
    # trellis_planes_kernel / trellis_duration_kernel.
    team = {}
    if inst is not None:
        k, a, b, c = inst
        name = (rf"planes_team_kernelILi{k}ELb{a}ELb{b}E" if planes
                else rf"duration_team_kernelILi{k}ELi{a}ELb{b}ELb{c}E")
        team = ptxas_resources(text, re.compile(name))
        if text and not team:
            raise SystemExit(f"phase 30: no ptxas entry for {name} in {path.name}")
    simple = r"trellis_planes_kernelE" if planes else r"trellis_duration_kernelE"
    return {"team": team, "simple": ptxas_resources(text, re.compile(simple))}


def stream_build(s, ring_bytes):
    """BUILD_RESOURCES' flat stream instantiation that S states and a ring of
    ring_bytes elements launch (K by S, the WIDE build past 20 warps of 8)."""
    k = 2 if s <= 64 else (4 if s <= 2048 else 8)
    wide = k == 8 and -(-s // 256) > 20
    ring = "int8" if ring_bytes == 1 else "int32"
    return next((r for r in BUILD_RESOURCES if r["mode"] == "stream" and not r["lm"]
                 and r["K"] == k and r["ring"] == ring and r["wide"] == wide), {})


def random_composite(num_words, seed, d=39):
    """num_words 5-state words + a 3-state silence, flagship-like Gaussians
    of dimension d."""
    from cs304_tpu_torch.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a

    rng = np.random.default_rng(seed)
    models = []
    for i in range(num_words + 1):
        s = 3 if i == num_words else 5
        a = rng.normal(size=(s, d, 8)).astype(np.float32) * 0.1
        models.append(WordHMM(
            label="S" if i == num_words else f"w{i}",
            means=rng.normal(size=(s, d)).astype(np.float32),
            covariances=a @ np.transpose(a, (0, 2, 1)) + 0.5 * np.eye(d, dtype=np.float32),
            log_a=uniform_forward_log_a(s)))
    return stack_word_models(models, penalty=-100.0)


def emission_edge_cases(dev, comp, frames, t_total):
    """(name, composite, frames) of phases 3 and 11 past the main-path
    shape: the K=2 GMM width (S*K = 116 columns), 503 and 5003 states,
    N = 1, N off every frame tile, D = 1 and D = 64 (random frames of those
    widths; D = 64 at 58 and at 503 states)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    odd = 64 * t_total + 37
    return (
        ("S*K=116", gmm_width(comp), frames),
        ("503-states", random_composite(100, 1), frames[: 64 * t_total]),
        ("5003-states", random_composite(1000, 2), frames[: 8 * t_total]),
        ("N=1", comp, frames[:1]),
        ("N-off-tile", comp, frames[:odd]),
        *((f"D={d}", random_composite(11, 4, d),
           torch.randn((odd, d), generator=gen, device=dev)) for d in (1, 64)),
        ("D=64,503-states", random_composite(100, 4, 64),
         torch.randn((odd, 64), generator=gen, device=dev)),
    )


def gmm_width(comp, k=2, seed=6):
    """The S*K columns a K-mixture decode of comp runs the quad tiers over:
    each state's Gaussian k times, the means jittered per component."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([comp.means + 0.1 * rng.normal(size=comp.means.shape)
                            for _ in range(k)]).astype(np.float32)
    return SimpleNamespace(num_states=k * comp.num_states, means=means,
                           covariances=np.concatenate([comp.covariances] * k))


def training_corpus(models, seed=1):
    """train_bench.sample_corpus's corpus: every transcript's
    silence-interleaved sentence walked state by state (2-5 frames each)
    around the model means, cut at MAX_FRAMES."""
    from cs304_tpu_torch.models.train_continuous import insert_silence

    rng = np.random.default_rng(seed)
    labeled = {}
    for transcript in TRAIN_TRANSCRIPTS:
        feats = []
        for _ in range(UTTS_PER_TRANSCRIPT):
            frames = []
            for word in insert_silence(transcript):
                m = models[word]
                for s_i, n in enumerate(rng.integers(2, 6, size=m.num_states)):
                    frames.append(m.means[s_i] + rng.normal(0, 0.7, size=(n, 39)))
            feats.append(np.concatenate(frames).astype(np.float32)[:MAX_FRAMES])
        labeled[transcript] = feats
    return labeled


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
    from cs304_tpu_torch.ops.gaussian import gaussian_log_pdf_quad, make_gaussian_quad_params
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
            if any(w in line for w in ("Used", "Compiling entry", "spill", "wgmma", "Loss")):
                print("  ptxas:", line.split("ptxas info    :")[-1].strip())
        BUILD_RESOURCES[:] = team_kernel_resources(ptxas.read_text())
        for kern in BUILD_RESOURCES:
            if kern["lm"]:
                log("build", lm_kernel=f"K={kern['K']}", mode=kern["mode"], ring=kern["ring"],
                    beam=kern["beam"], **{k: kern.get(k) for k in (
                        "stack_bytes", "spill_stores", "spill_loads", "registers")})
            elif kern["mode"] == "stream" or kern["beam"]:
                log("build", team_kernel=f"K={kern['K']}", mode=kern["mode"],
                    ring=kern["ring"], beam=kern["beam"], wide=kern["wide"],
                    **{k: kern.get(k) for k in (
                        "stack_bytes", "spill_stores", "spill_loads", "registers")})

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
    def k1_check(name, composite, frames_in, unpadded=False):
        s_k = composite.num_states
        s_pad = s_k if unpadded else -(-s_k // 128) * 128
        packed = em.pack_quad_params(composite.means, composite.covariances, s_pad, device=dev)
        if unpadded:  # the call gaussian_log_pdf_quad makes: s_pad = S
            qp = make_gaussian_quad_params(composite.means, composite.covariances, device=dev)
            got = kernel_runs("emission", gaussian_log_pdf_quad, qp, frames_in[None])[0][0]
        else:
            got = kernel_runs("emission", em.emission, frames_in, *packed, num_states=s_k,
                              s_pad=s_pad)[0]
        want = plain_run(em.emission_plain, frames_in, *packed)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        pad_zero = bool((got[:, s_k:] == 0).all().item())
        ok = torch.allclose(got, want, rtol=RTOL_K1, atol=ATOL_K1)
        log("K1", case=name, N=frames_in.shape[0], D=frames_in.shape[1], S=s_k,
            s_pad=s_pad, max_abs_err=err, pad_zero=pad_zero, ok=ok)
        if not (ok and pad_zero and torch.isfinite(got).all().item()):
            raise SystemExit(f"K1 disagrees with its plain version ({name})")
        return got, err

    log_b_flag, k1_err = k1_check("flagship", comp, frames)
    # bench.py's shape: the same clips unpadded, N = 512 * 151 frames.
    feats_bench, _ = mfcc_features_batch(torch.as_tensor(signals, device=dev), ns_dev)
    edge_cases = emission_edge_cases(dev, comp, frames, t_total)
    for name, composite, frames_in in (
            ("bench-shape", comp, feats_bench.reshape(-1, d)), *edge_cases):
        k1_err = max(k1_err, k1_check(name, composite, frames_in)[1])
    k1_err = max(k1_err, k1_check("s_pad=S", comp, frames[:4099], unpadded=True)[1])

    # -- 4. K2 vs plain -----------------------------------------------------
    k2_err = 0.0

    def k2_check(name, composite, log_b, lengths, codes="shared"):
        """The decode-mode kernel against viterbi_composite_batch_fast, the
        backpointer-mode forward against forward_fast, K2-bt against
        backtrace_batch on forward_fast's backpointers: all bitwise. codes:
        where the decode kernel must keep its backpointer codes."""
        nonlocal k2_err
        coefs = pack_coefs(composite.log_a, composite.lower_of_state,
                           composite.is_entry, composite.is_exit, device=dev)
        s_k = composite.num_states
        got_s, got_p = kernel_runs("trellis_decode", tsf.scanfree_decode, log_b, coefs,
                                   composite.penalty, lengths)[0]
        want_s, want_p = plain_run(
            viterbi_composite_batch_fast, log_b[..., :s_k].contiguous(), composite.log_a,
            composite.lower_of_state, composite.is_entry, composite.is_exit,
            composite.penalty, lengths)
        alpha, bp = kernel_runs("trellis_forward", tsf.trellis_forward, log_b, coefs,
                                composite.penalty, lengths)[0]
        want_a, want_bp = plain_run(forward_fast, log_b, coefs, composite.penalty, lengths)
        _, best = first_max(want_a, coefs[5] > 0)
        bt_p = kernel_runs("trellis_backtrace", tsf.trellis_backtrace, want_bp, best,
                           lengths)[0]
        torch.cuda.synchronize()
        same = {"scores": torch.equal(got_s, want_s), "paths": torch.equal(got_p, want_p),
                "alpha": torch.equal(alpha, want_a), "bp": torch.equal(bp, want_bp),
                "bt_paths": torch.equal(bt_p, want_p)}
        both = torch.isfinite(got_s) & torch.isfinite(want_s)
        err = (got_s - want_s)[both].abs().max().item() if both.any() else 0.0
        k2_err = max(k2_err, err)
        b_k, t_k, ld_k = log_b.shape
        took = "shared" if tsf.codes_scratch_bytes(b_k, t_k, s_k) == 0 else "global"
        log("K2", case=name, B=b_k, T=t_k, S=s_k, ld=ld_k, codes=took,
            length_1_rows=int((lengths == 1).sum()), equal=json.dumps(same),
            max_abs_err=err, neg_inf_scores=int((~torch.isfinite(got_s)).sum()))
        if not all(same.values()):
            raise SystemExit(f"K2 disagrees with its plain version ({name})")
        if took != codes:
            raise SystemExit(f"K2 case {name} kept its codes in {took} memory, not {codes}")

    gen = torch.Generator(device=dev).manual_seed(0)
    rand_len = torch.randint(1, t_total + 1, (BATCH,), generator=gen, device=dev,
                             dtype=torch.int32)
    lb_flag3 = log_b_flag.reshape(b, t_total, -1)
    k2_check("flagship-emissions", comp, lb_flag3, rand_len)
    # ld = S = 58: rows 8-byte aligned, not 16; and rows of length 1.
    short_len = rand_len.clone()
    short_len[::7] = 1
    k2_check("ld=S,length-1", comp, lb_flag3[..., :s].contiguous(), short_len)
    # 98 states: one warp of 4 states a lane (the K6 wrapper's range); 503:
    # a team of 4 warps; 5003: 20 warps of 8, codes in a global scratch.
    for words, nb, codes in ((19, 16, "shared"), (100, 16, "shared"), (1000, 8, "global")):
        c_k = random_composite(words, 3)
        lb = 3 * torch.randn((nb, t_total, c_k.num_states), generator=gen, device=dev)
        ln = torch.randint(1, t_total + 1, (nb,), generator=gen, device=dev, dtype=torch.int32)
        k2_check(f"{c_k.num_states}-states", c_k, lb, ln, codes)
    lb1 = torch.randn((5, 1, s), generator=gen, device=dev)
    k2_check("B5-T1", comp, lb1, torch.ones(5, dtype=torch.int32, device=dev))
    lbi = torch.randint(-3, 1, (64, 40, s), generator=gen, device=dev).to(torch.float32)
    k2_check("integer-ties", comp, lbi,
             torch.randint(1, 41, (64,), generator=gen, device=dev, dtype=torch.int32))
    long_len = torch.randint(1, 1281, (8,), generator=gen, device=dev, dtype=torch.int32)
    long_len[0] = 1280
    k2_check("T=1280", comp, 3 * torch.randn((8, 1280, s), generator=gen, device=dev), long_len)
    # The global-codes branch with one-warp teams (T = 4000 at 58 states,
    # four a block, the last block short) and with 4-warp teams (503 states
    # at T = 500).
    long_len = torch.randint(1, 4001, (6,), generator=gen, device=dev, dtype=torch.int32)
    long_len[0] = 4000
    k2_check("T=4000", comp, 3 * torch.randn((6, 4000, s), generator=gen, device=dev),
             long_len, "global")
    c_k = random_composite(100, 3)
    ln = torch.randint(1, 501, (4,), generator=gen, device=dev, dtype=torch.int32)
    ln[0] = 500
    k2_check("503-states,T=500", c_k,
             3 * torch.randn((4, 500, c_k.num_states), generator=gen, device=dev), ln, "global")

    # -- 5. main path -------------------------------------------------------
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                            device="cuda")
    if dec.backend != "scanfree":
        raise SystemExit(f"backend 'auto' resolved to {dec.backend!r} on CUDA")
    # The same features predict_signal_batch computes, as a ragged list.
    feat_list = [f[:n].cpu().numpy() for f, n in zip(feats, n_frames.tolist())]
    counters = {"emission": em.emission, "trellis_decode": tsf.scanfree_decode,
                "trellis_forward": tsf.trellis_forward,
                "trellis_backtrace": tsf.trellis_backtrace}
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    texts_sig = dec.predict_signal_batch(list(signals))
    texts_feat = dec.predict_batch(feat_list)
    torch.cuda.synchronize()
    main_launches = {name: c.launches for name, c in counters.items()}
    log("main", launches=json.dumps(main_launches), distinct_transcripts=len(set(texts_sig)),
        sample=repr(texts_sig[:4]))
    launches = {name: main_launches[name] for name in ("emission", "trellis_decode")}
    if not all(n > 0 for n in launches.values()):
        raise SystemExit(f"a kernel of the main path never launched: {launches}")
    if main_launches["trellis_forward"] or main_launches["trellis_backtrace"]:
        raise SystemExit(f"the main path launched a trellis kernel besides the decode "
                         f"kernel: {main_launches}")

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
    kernel_fn = lambda: dec.decode_signals(sig_dev, ns_dev)  # noqa: E731
    plain_fn = lambda: plain_path(sig_dev, ns_dev)  # noqa: E731
    kernel_fn(), plain_fn()
    t_plain1, t_kern1 = window(plain_fn), window(kernel_fn)
    t_kern2, t_plain2 = window(kernel_fn), window(plain_fn)
    t_kern, t_plain = min(t_kern1, t_kern2), min(t_plain1, t_plain2)
    log("timing", path="kernels", ms_per_batch=t_kern, utt_per_s=BATCH / t_kern * 1e3)
    log("timing", path="plain", ms_per_batch=t_plain, utt_per_s=BATCH / t_plain * 1e3)

    # The kernels at the main path's inputs, on the decoder's cached operands.
    packed, folded = dec._quad, dec._folded
    log_b_main = em.emission(frames, *packed, num_states=s, s_pad=dec._s_pad, folded=folded)
    lb3 = log_b_main.reshape(b, t_total, -1)
    coefs, pen = dec._coefs, comp.penalty
    alpha, bp = tsf.trellis_forward(lb3, coefs, pen, n_frames)
    _, best = first_max(alpha, coefs[5] > 0)

    def old_chain():
        a, p_ = tsf.trellis_forward(lb3, coefs, pen, n_frames)
        _, bst = first_max(a, coefs[5] > 0)
        return tsf.trellis_backtrace(p_, bst, n_frames)

    def plain_decode():
        a, p_ = forward_fast(lb3, coefs, pen, n_frames)
        sc, bst = first_max(a, coefs[5] > 0)
        return sc, backtrace_batch(p_, bst, n_frames)

    timings = {
        "emission": (device_ms(lambda: em.emission(frames, *packed, num_states=s,
                                                 s_pad=dec._s_pad, folded=folded)),
                     cuda_ms(lambda: em.emission_plain(frames, *packed))),
        "trellis_decode": (device_ms(lambda: tsf.scanfree_decode(lb3, coefs, pen, n_frames)),
                           cuda_ms(plain_decode, reps=3)),
        "trellis_forward": (device_ms(lambda: tsf.trellis_forward(lb3, coefs, pen, n_frames)),
                            cuda_ms(lambda: forward_fast(lb3, coefs, pen, n_frames), reps=3)),
        "trellis_backtrace": (device_ms(lambda: tsf.trellis_backtrace(bp, best, n_frames)),
                              cuda_ms(lambda: backtrace_batch(bp, best, n_frames), reps=3)),
    }
    # The eager loop (host launch work included) beside the device time: the
    # parent commit's chip_smoke.py timed K2 so.
    eager = {"trellis_decode": cuda_ms(lambda: tsf.scanfree_decode(lb3, coefs, pen, n_frames)),
             "trellis_forward": cuda_ms(lambda: tsf.trellis_forward(lb3, coefs, pen, n_frames)),
             "trellis_backtrace": cuda_ms(lambda: tsf.trellis_backtrace(bp, best, n_frames)),
             "chain": cuda_ms(old_chain)}
    for name, (ms, plain_ms) in timings.items():
        log("timing", kernel=name, ms=ms, plain_ms=plain_ms, eager_ms=eager.get(name),
            shape=f"B={b} T={t_total} S={s} ld={lb3.shape[2]}")
    # The chain the decode kernel replaced, and the time of one step: the
    # slope between two runs that differ only in the steps they take
    # (decode: lengths cut to 51; backpointer mode: T cut to 101).
    chain_ms = device_ms(old_chain)
    steps_dec = int(n_frames.clamp(max=t_total).max()) - 1
    short = n_frames.clamp(max=51)
    dec_short = device_ms(lambda: tsf.scanfree_decode(lb3, coefs, pen, short))
    lb_half = lb3[:, :101].contiguous()
    fwd_half = device_ms(lambda: tsf.trellis_forward(lb_half, coefs, pen, n_frames))
    step_us = {
        "trellis_decode": (timings["trellis_decode"][0] - dec_short) / (steps_dec - 50) * 1e3,
        "trellis_forward": (timings["trellis_forward"][0] - fwd_half) / 100 * 1e3,
    }
    for name, steps in (("trellis_decode", steps_dec), ("trellis_forward", t_total - 1)):
        log("timing", kernel=name, steps=steps,
            us_per_step=timings[name][0] / steps * 1e3, slope_us_per_step=step_us[name],
            serial_floor_ms=steps * step_us[name] / 1e3)
    log("timing", chain="trellis_forward+first_max+trellis_backtrace", ms=chain_ms,
        eager_ms=eager["chain"], decode_kernel_ms=timings["trellis_decode"][0])

    decode = {"comp": comp, "signals": signals, "sig_dev": sig_dev, "ns_dev": ns_dev,
              "feat_list": feat_list,
              "frames": frames, "packed": packed, "lb3": lb3, "n_frames": n_frames,
              "rand_len": rand_len, "texts_sig": texts_sig, "dec": dec,
              "emission_cases": (("bench-shape", comp, feats_bench.reshape(-1, d)),
                                 *edge_cases)}
    errs = {"emission": k1_err, "trellis_decode": k2_err, "trellis_forward": k2_err,
            "trellis_backtrace": k2_err}
    pipe = train_phases(dev, launches, timings, errs)
    yardsticks = slice_phases(dev, decode, pipe, launches, timings, errs)
    stream_phase(dev, launches, timings, errs, yardsticks)
    serving_phase(dev, pipe)
    bw_gmm_phases(dev, pipe, launches, timings, errs, yardsticks)
    search_phase(dev, decode, pipe, launches, timings, errs, yardsticks)
    constrained_phase(dev, decode, pipe, timings, errs, yardsticks)
    lattice_phase(dev, decode, pipe, launches, timings, errs, yardsticks)
    slice4b_phases(dev, decode, pipe, launches, timings, errs, yardsticks)
    phone_tier_phase(dev, smi)
    cli_phase(dev, smi)
    data_parallel_phase(dev, smi, decode, pipe)
    slice10_phase(dev, pipe, launches, timings, errs, yardsticks, smi)
    report(kind, launches, timings, errs, yardsticks)


def train_phases(dev, launches, timings, errs):
    """Phases 7-10 (the embedded-training slice). Returns what phase 15
    decodes: the phase-9 models and their evaluation features."""
    from cs304_tpu_torch.audio.endpointing import SignalSeparation
    from cs304_tpu_torch.data.synthetic import SyntheticTIDigits
    from cs304_tpu_torch.data.ti_digits import DIGIT_LABELS
    from cs304_tpu_torch.models import train_fused as tf
    from cs304_tpu_torch.models.decoder import ContinuousDecoder
    from cs304_tpu_torch.models.hmm import flagship_models
    from cs304_tpu_torch.models.train_continuous import (
        ContinuousTrainConfig,
        ContinuousTrainer,
        insert_silence,
    )
    from cs304_tpu_torch.models.train_kmeans import (
        SegmentalKMeansConfig,
        train_digit_models,
        train_word_hmm,
    )
    from cs304_tpu_torch.ops.cuda import trellis_banded as tb
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.mfcc import mfcc_batch
    from cs304_tpu_torch.ops.viterbi import backtrace_batch, banded_sentence_forward

    # -- 7. K3 vs plain -----------------------------------------------------
    boot = {m.label: m for m in flagship_models(seed=0)}
    labeled = training_corpus(boot)
    probe = ContinuousTrainer(dict(boot), device=dev)
    corpus = tf.prepare_fused_corpus(labeled, probe.state_counts, probe.label_index,
                                     insert_silence, 32, device=dev)
    means, covs, log_a = probe._device_state()
    n_chunks, c, t_total, _ = corpus.batch.shape
    b_all = n_chunks * c
    topo = corpus.topo_id.reshape(-1).long()
    lb_sent = tf._gather_sentence_emissions(
        means, covs, corpus.lab_tab, corpus.loc_tab, corpus.batch, corpus.topo_id,
        probe.s_max).reshape(b_all, t_total, -1)
    diags = tf._sentence_trans_diagonals(
        log_a, corpus.lab_tab[topo], corpus.loc_tab[topo], corpus.samew_tab[topo],
        corpus.cross_tab[topo], "exit_only")
    train_lengths = corpus.lengths.reshape(-1)
    train_n_states = corpus.n_states_t[topo]
    s_sent = lb_sent.shape[-1]
    log("K3", corpus=f"B={b_all} (utterances {corpus.num_utts}) T={t_total} "
        f"S_sent={s_sent} frames={corpus.num_frames}")
    k3_err = 0.0

    def k3_check(name, log_b, c0, c1, c2, lengths, n_states, codes="shared"):
        """The sentence decode mode against _banded_trellis_batch (scores and
        full paths) and the backpointer mode against banded_sentence_forward
        (alpha and bp): all bitwise. codes: where the decode mode must keep
        its backpointer codes."""
        nonlocal k3_err
        got_s, got_p = kernel_runs("trellis_banded_decode", tb.viterbi_banded_batch_scanfree,
                                   log_b, c0, c1, c2, lengths, n_states)[0]
        want_s, want_p = plain_run(tf._banded_trellis_batch, log_b, c0, c1, c2, lengths,
                                   n_states)
        alpha, bp = kernel_runs("trellis_banded_forward", tb.banded_forward, log_b, c0, c1,
                                c2, lengths)[0]
        want_a, want_bp = plain_run(banded_sentence_forward, log_b, c0, c1, c2, lengths)
        torch.cuda.synchronize()
        same = {"scores": torch.equal(got_s, want_s), "paths": torch.equal(got_p, want_p),
                "alpha": torch.equal(alpha, want_a), "bp": torch.equal(bp, want_bp)}
        both = torch.isfinite(got_s) & torch.isfinite(want_s)
        err = (got_s - want_s)[both].abs().max().item() if both.any() else 0.0
        k3_err = max(k3_err, err)
        b_k, t_k, s_k = log_b.shape
        took = "shared" if tsf.codes_scratch_bytes(b_k, t_k, s_k) == 0 else "global"
        log("K3", case=name, B=b_k, T=t_k, S=s_k, codes=took, equal=json.dumps(same),
            max_abs_err=err, neg_inf_scores=int((~torch.isfinite(got_s)).sum()))
        if not all(same.values()):
            raise SystemExit(f"K3 disagrees with its plain version ({name})")
        if took != codes:
            raise SystemExit(f"K3 case {name} kept its codes in {took} memory, not {codes}")

    k3_check("training-shape", lb_sent, *diags, train_lengths, train_n_states)
    gen = torch.Generator(device=dev).manual_seed(3)

    def problem(b, t, s, ties=False, degenerate=False, zero_length=False):
        def rand(*shape):
            x = torch.randn(shape, generator=gen, device=dev)
            return torch.round(2 * x) if ties else x

        c0, c1, c2 = (0.5 * rand(b, s) for _ in range(3))
        c1[:, :1] = float("-inf")
        c2[:, :2] = float("-inf")
        for cc in (c0, c1, c2):
            cc[torch.rand((b, s), generator=gen, device=dev) < 0.15] = float("-inf")
        if degenerate:
            c0[:, 0] = float("-inf")
        lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
        if zero_length:
            lengths[1::3] = 0
        n_states = torch.randint(max(1, s - 8), s + 1, (b,), generator=gen,
                                 device=dev, dtype=torch.int32)
        return rand(b, t, s), c0, c1, c2, lengths, n_states

    k3_check("random-inf", *problem(256, 160, 59))
    k3_check("integer-ties", *problem(256, 160, 59, ties=True))
    k3_check("degenerate-entry", *problem(64, 100, 59, degenerate=True))
    k3_check("length-0-rows", *problem(64, 100, 59, ties=True, zero_length=True))
    k3_check("B5-T1", *problem(5, 1, 59))
    k3_check("503-states", *problem(16, 160, 503))
    # Teams of 9 warps, 8 states a lane; and codes in a global scratch.
    k3_check("2100-states", *problem(4, 40, 2100))
    k3_check("T=4000", *problem(6, 4000, 59), codes="global")

    # -- 8. full-width training, K3 vs plain trellis -------------------------
    cfg = ContinuousTrainConfig(max_iterations=3, silence_bootstrap=False,
                                cov_reg=0.1, on_empty_state="keep")
    counters = (tb.banded_decode, tb.banded_forward, tsf.trellis_backtrace)
    runs = {}
    for backend in ("scanfree", "scan"):
        tf._TRELLIS_BACKEND = backend
        trainer = ContinuousTrainer(dict(boot), cfg, device=dev)
        for k in counters:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_it = trainer.train(labeled)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[backend] = (trainer, n_it, {k.__name__: k.launches for k in counters})
        log("train", trellis=backend, iterations=n_it, seconds=f"{seconds:.3f}",
            launches=json.dumps(runs[backend][2]),
            empty_slots=len(trainer.last_empty_slots))
    tf._TRELLIS_BACKEND = "scanfree"
    (tr_k, it_k, train_launches), (tr_p, it_p, plain_launches) = runs["scanfree"], runs["scan"]
    if train_launches["banded_decode"] == 0:
        raise SystemExit(f"the training path never launched the decode mode: {train_launches}")
    if train_launches["banded_forward"] or train_launches["trellis_backtrace"]:
        raise SystemExit(f"the training path launched a trellis kernel besides the decode "
                         f"mode: {train_launches}")
    if any(plain_launches.values()):
        raise SystemExit(f"the plain training trellis launched a kernel: {plain_launches}")
    same = {n: np.array_equal(getattr(tr_k, n), getattr(tr_p, n), equal_nan=True)
            for n in ("means_g", "covs_g", "log_a_g")}
    finite = all(np.isfinite(getattr(tr_k, n)).all() for n in ("means_g", "covs_g"))
    log("train", iterations_equal=it_k == it_p, params_equal=json.dumps(same),
        finite=finite, means_shape=tr_k.means_g.shape)
    # Every statistic is a matmul, a sum or an integer histogram (no float
    # atomics), and K3 is bitwise its plain version: the two runs must agree
    # exactly.
    if not (it_k == it_p and all(same.values()) and finite):
        raise SystemExit("K3-trained and plain-trained parameters differ")

    args = tr_k._fused_args(corpus)
    kwargs = tr_k._fused_kwargs()
    outs = {}
    for backend in ("scanfree", "scan"):
        tf._TRELLIS_BACKEND = backend
        outs[backend] = tf.fused_viterbi_iteration(*args, **kwargs)
    tf._TRELLIS_BACKEND = "scanfree"
    torch.cuda.synchronize()
    names = ("means", "covs", "log_a", "counts", "converged", "paths")
    iter_same = {n: torch.equal(a, b) for n, a, b in zip(names, outs["scanfree"], outs["scan"])}
    log("train", one_iteration_equal=json.dumps(iter_same))
    if not all(iter_same.values()):
        raise SystemExit("one fused iteration differs between K3 and the plain trellis")

    def iteration_ms(backend):
        """Best of 3: one iteration, a synchronize and a host copy of the new
        parameters (benchmarks/train_bench.py's rule)."""
        tf._TRELLIS_BACKEND = backend
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = tf.fused_viterbi_iteration(*args, **kwargs)
            torch.cuda.synchronize()
            [o.cpu() for o in out[:3]]
            best = min(best, time.perf_counter() - t0)
        tf._TRELLIS_BACKEND = "scanfree"
        return best * 1e3

    iteration_ms("scanfree")
    it_ms = {}
    for backend in ("scan", "scanfree", "scanfree", "scan"):
        it_ms[backend] = min(it_ms.get(backend, float("inf")), iteration_ms(backend))
    # Split by stage (CUDA events, fixed inputs): emissions, trellis (the
    # diagonals and the K3 or plain decode), pass A, pass B; the M-step and
    # glue are what remains of the event-timed iteration.
    f = len(tr_k.labels) * tr_k.s_max
    paths = outs["scanfree"][5].reshape(b_all, t_total)
    lab_u, loc_u, pos_u = (x[topo] for x in (corpus.lab_tab, corpus.loc_tab, corpus.pos_tab))
    pa = tf._pass_a(paths, lab_u, loc_u, pos_u, corpus.batch, train_lengths, tr_k.s_max, f)
    new_means_flat = outs["scanfree"][0].reshape(f, -1)

    def trellis_fn(backend):
        def run():
            tf._TRELLIS_BACKEND = backend
            d3 = tf._sentence_trans_diagonals(
                args[2], lab_u, loc_u, corpus.samew_tab[topo], corpus.cross_tab[topo],
                "exit_only")
            out = tf._training_trellis(lb_sent, *d3, train_lengths, train_n_states)
            tf._TRELLIS_BACKEND = "scanfree"
            return out
        return run

    stage = {
        "emissions": cuda_ms(lambda: tf._gather_sentence_emissions(
            args[0], args[1], corpus.lab_tab, corpus.loc_tab, corpus.batch,
            corpus.topo_id, tr_k.s_max), reps=5),
        "trellis_k3": cuda_ms(trellis_fn("scanfree"), reps=5),
        "trellis_plain": cuda_ms(trellis_fn("scan"), reps=3),
        "pass_a": cuda_ms(lambda: tf._pass_a(paths, lab_u, loc_u, pos_u, corpus.batch,
                                             train_lengths, tr_k.s_max, f), reps=5),
        "pass_b": cuda_ms(lambda: tf._pass_b(corpus.batch, pa[4], pa[3], new_means_flat),
                          reps=5),
        "iteration_k3": cuda_ms(lambda: tf.fused_viterbi_iteration(*args, **kwargs), reps=5),
    }
    stage["m_step_and_glue"] = stage["iteration_k3"] - (
        stage["emissions"] + stage["trellis_k3"] + stage["pass_a"] + stage["pass_b"])
    log("timing", what="training iteration, host wall best of 3 with readback",
        ms_k3=it_ms["scanfree"], ms_plain=it_ms["scan"],
        utt_per_s_k3=corpus.num_utts / it_ms["scanfree"] * 1e3)
    log("timing", what="training stages (CUDA events)",
        **{k: f"{v:.4f}" for k, v in stage.items()})

    # -- 9. the whole pipeline ---------------------------------------------
    t0 = time.perf_counter()
    synth = SyntheticTIDigits(num_train_speakers=6, num_test_speakers=2, takes_per_digit=3)
    sep = SignalSeparation()
    feats = {l: mfcc_batch(sep.remove_empty_batch(synth.train_dataset[l]), device=dev)
             for l in DIGIT_LABELS}
    t_front = time.perf_counter() - t0
    pipe_boot = train_digit_models(
        feats, SegmentalKMeansConfig(num_states=5, max_iterations=15, length_multiple=32),
        device=dev)
    noises = [n for n in sep.get_all_noises() if len(n) >= 9 * sep.frame_size]
    pipe_boot["S"] = train_word_hmm(
        "S", mfcc_batch(noises, device=dev),
        SegmentalKMeansConfig(num_states=3, max_iterations=15, length_multiple=32),
        device=dev).model
    t_boot = time.perf_counter() - t0 - t_front
    pipe_labeled = {
        tr: mfcc_batch([synth.sentence_audio(tr, spk, jitter_seed=take)
                        for spk in range(6) for take in range(3)], device=dev)
        for tr in PIPELINE_TRANSCRIPTS
    }
    for k in counters:
        k.launches = 0
    trainer = ContinuousTrainer(
        dict(pipe_boot),
        ContinuousTrainConfig(max_iterations=4, length_multiple=64, cov_reg=0.1),
        device=dev)
    pipe_it = trainer.train(pipe_labeled)
    torch.cuda.synchronize()
    pipe_launches = {k.__name__: k.launches for k in counters}
    decoder = ContinuousDecoder(trainer.models(), penalty=-100.0, device=dev)
    acc, pipe_eval = {}, {}
    for split, speakers in (("train_speakers", range(6)), ("unseen_speakers", (6, 7))):
        truths = [tr for tr in PIPELINE_TRANSCRIPTS for _ in speakers]
        clips = [synth.sentence_audio(tr, spk, jitter_seed=33)
                 for tr in PIPELINE_TRANSCRIPTS for spk in speakers]
        pipe_eval[split] = (truths, mfcc_batch(clips, device=dev))
        preds = decoder.predict_batch(pipe_eval[split][1])
        acc[split] = float(np.mean([p == t for p, t in zip(preds, truths)]))
    log("pipeline", iterations=pipe_it, launches=json.dumps(pipe_launches),
        exact_seq_acc=json.dumps(acc), seconds_front_end=f"{t_front:.2f}",
        seconds_boot=f"{t_boot:.2f}", seconds_total=f"{time.perf_counter() - t0:.2f}")
    if pipe_launches["banded_decode"] == 0:
        raise SystemExit(f"the pipeline's training never launched a kernel: {pipe_launches}")
    if acc["train_speakers"] < ACC_BAR:
        raise SystemExit(f"exact-sequence accuracy {acc['train_speakers']} < {ACC_BAR}")

    # -- 10. K3 timing -------------------------------------------------------
    # The decode mode (the training path's one launch), the backpointer mode,
    # and the chain the decode mode replaced: the backpointer mode, K2-bt on
    # its backpointers and the gather of the score.
    k3_args = (lb_sent, *diags, train_lengths)
    final3 = tb.final_states(train_n_states, s_sent)
    _alpha3, bp3 = tb.banded_forward(*k3_args)

    def k3_chain():
        alpha, bp = tb.banded_forward(*k3_args)
        sc = alpha.gather(1, final3[:, None].to(torch.int64))[:, 0]
        return sc, tsf.trellis_backtrace(bp, final3, train_lengths)

    timings["trellis_banded_decode"] = (
        device_ms(lambda: tb.banded_decode(*k3_args, final3)),
        cuda_ms(lambda: tf._banded_trellis_batch(*k3_args, train_n_states), reps=3))
    timings["trellis_banded_forward"] = (
        device_ms(lambda: tb.banded_forward(*k3_args)),
        cuda_ms(lambda: banded_sentence_forward(*k3_args), reps=3))
    timings["trellis_backtrace_k3"] = (
        device_ms(lambda: tsf.trellis_backtrace(bp3, final3, train_lengths)),
        cuda_ms(lambda: backtrace_batch(bp3, final3, train_lengths), reps=3))
    chain3 = device_ms(k3_chain)
    shape3 = f"B={b_all} T={t_total} S={s_sent}"
    for name in ("trellis_banded_decode", "trellis_banded_forward", "trellis_backtrace_k3"):
        log("timing", kernel=name, ms=timings[name][0], plain_ms=timings[name][1],
            shape=shape3)
    log("timing", chain="banded_forward+gather+trellis_backtrace", ms=chain3,
        eager_decode_ms=cuda_ms(lambda: tb.banded_decode(*k3_args, final3)),
        decode_mode_ms=timings["trellis_banded_decode"][0], shape=shape3)
    # The training path no longer runs the backpointer mode: its count from
    # phase 8 is 0.
    launches["trellis_banded_decode"] = train_launches["banded_decode"]
    launches["trellis_banded_forward"] = train_launches["banded_forward"]
    errs["trellis_banded_decode"] = errs["trellis_banded_forward"] = k3_err
    return {"models": trainer.models(), "eval": pipe_eval, "k3_args": k3_args,
            "corpus": synth, "n_states": train_n_states, "boot": boot, "labeled": labeled,
            "pipe_labeled": pipe_labeled, "digit_feats": feats, "seconds_boot": t_boot}


def bound(bytes_moved, ops=()):
    """The least time the card could take (ms) and what sets it: bytes
    over the memory rate against the sum of operations over their type's
    peak, ops = ((count, peak per second), ...)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = sum(n / peak for n, peak in ops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def emission_bound(n, d, s, s_pad, tier, folded=True, fp32_linear=False):
    """bound() of one emission call: N frames in, (N, s_pad) out, the S
    states' parameters (bf16 nhp halves below "highest"); the quad and
    linear terms' products in FP32 ("highest"), three bf16 passes ("high":
    the quad term, and the linear term at float32 accuracy as the six
    products of bf16 thirds, 3D rows; fp32_linear: as one FP32 product, as
    the bounds before that), or one bf16 pass for both ("default"). The
    quad term needs D(D+1)/2 products per (frame, state), x2 being
    symmetric; folded=False counts all D*D, as the bounds before the fold
    did."""
    k = d * (d + 1) // 2 if folded else d * d
    moved = 4 * n * d + 4 * (d + 1) * s + 4 * n * s_pad
    if tier == "highest":
        return bound(moved + 4 * k * s, [(2 * n * (k + d) * s, PEAK_FP32)])
    if tier == "high":
        if fp32_linear:
            return bound(moved + 4 * k * s, [(3 * 2 * n * k * s, PEAK_BF16),
                                             (2 * n * d * s, PEAK_FP32)])
        return bound(moved + 4 * k * s, [(3 * 2 * n * (k + 3 * d) * s, PEAK_BF16)])
    return bound(moved + 2 * k * s, [(2 * n * (k + d) * s, PEAK_BF16)])


def dense_bound(b, t, s, lengths):
    """bound() of one dense trellis forward: log_b rows up to each length in,
    every backpointer out, trans, alpha0 and alpha; an add and a compare
    per (step, predecessor, state) at PEAK_FP32_ALU, over the steps these
    lengths need (the live ones and the first frozen one, whose backpointer
    row every later row repeats)."""
    live = int(lengths.clamp(max=t).sum().item())
    steps = int(((lengths.clamp(min=1) + 1).clamp(max=t) - 1).sum().item())
    return bound(4 * live * s + 4 * b * t * s + 4 * s * s + 8 * b * s + 4 * b,
                 [(2 * steps * s * s, PEAK_FP32_ALU)])


def slice_phases(dev, decode, pipe, launches, timings, errs):
    """Phases 11-16: the decoder's other backends and precision tiers (the
    split emission kernel, the dense trellis kernel, the K5/K6 wrappers).
    Returns every kernel's yardsticks: name -> (library_ms, bound_ms,
    bound_by)."""
    from cs304_tpu_torch.models.decoder import ContinuousDecoder
    from cs304_tpu_torch.models.hmm import flagship_models
    from cs304_tpu_torch.ops.cuda import emission as em
    from cs304_tpu_torch.ops.cuda import trellis_dense as tdn
    from cs304_tpu_torch.ops.cuda import trellis_fast as tfast
    from cs304_tpu_torch.ops.cuda import trellis_lanes as tlanes
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.viterbi import (
        composite_transition_matrix,
        dense_decode,
        dense_forward,
        forward_fast,
        pack_coefs,
    )

    comp, frames = decode["comp"], decode["frames"]
    s = comp.num_states
    b, t_total, _ld = decode["lb3"].shape
    d = frames.shape[1]
    kw = dict(penalty=-100.0, emissions="quad", device="cuda")

    # -- 11. K1-split vs plain ----------------------------------------------
    split_err = {"high": 0.0, "default": 0.0}

    def split_check(name, composite, frames_in):
        s_k = composite.num_states
        sp = -(-s_k // 128) * 128
        nhp, lin, const = em.pack_quad_params(composite.means, composite.covariances, sp,
                                              device=dev)
        hi, lo = em.split_hi_lo(nhp)
        highest = em.emission(frames_in, nhp, lin, const, s_k, sp)
        for tier, passes in em.PASSES.items():
            got = kernel_runs("emission_split", em.emission_split, frames_in, hi, lo, lin,
                              const, s_k, sp, passes)[0]
            want = plain_run(em.emission_split_plain, frames_in, hi, lo, lin, const, passes)
            torch.cuda.synchronize()
            err = (got - want)[:, :s_k].abs().max().item()
            split_err[tier] = max(split_err[tier], err)
            pad_zero = bool((got[:, s_k:] == 0).all().item())
            ok = torch.allclose(got[:, :s_k], want[:, :s_k], rtol=RTOL_K1, atol=ATOL_K1)
            log("K1-split", case=name, tier=tier, N=frames_in.shape[0], D=frames_in.shape[1],
                S=s_k, s_pad=sp,
                max_abs_err=err, max_abs_vs_highest=(got - highest).abs().max().item(),
                pad_zero=pad_zero, ok=ok)
            if not (ok and pad_zero and torch.isfinite(got).all().item()):
                raise SystemExit(f"K1-split ({tier}) disagrees with its plain version ({name})")
            del want

    split_check("flagship", comp, frames)
    for case in decode["emission_cases"]:
        split_check(*case)
    for tier in ("highest", "high"):
        args = (comp.means, comp.covariances, frames)
        # Both are kernel calls: "concat" under the third poison.
        concat = plain_run(em.gaussian_log_pdf_fused, *args, precision=tier)
        selmm = kernel_runs("emission" if tier == "highest" else "emission_split",
                            em.gaussian_log_pdf_fused, *args, precision=tier,
                            x2_mode="selmm")[0]
        same = torch.equal(concat, selmm)
        log("K1-selmm", tier=tier, bitwise_equal_concat=same)
        if not same:
            raise SystemExit(f"x2_mode='selmm' differs from 'concat' at {tier}")
    errs["emission_split"] = max(split_err.values())

    # -- 12. K4 vs plain ----------------------------------------------------
    k4_err = 0.0

    def k4_check(name, branch, log_b, lengths, composite=None, trans=None, alpha0=None):
        """K4 against dense_forward (alpha with its signs of zero, bp), and on
        a composite the pallas decode against dense_decode: all bitwise.
        branch: the kernel branch the case must take."""
        nonlocal k4_err
        if composite is not None:
            topo = (composite.log_a, composite.lower_of_state, composite.is_entry,
                    composite.is_exit)
            trans = composite_transition_matrix(*topo, composite.penalty, device=dev)
            coefs = pack_coefs(*topo, device=dev)
            alpha0 = torch.where(coefs[4] > 0, log_b[:, 0, : trans.shape[0]] + coefs[6],
                                 float("-inf"))
        got = kernel_runs("trellis_dense_forward", tdn.trellis_dense_forward, log_b, trans,
                          alpha0, lengths)[0]
        want = plain_run(dense_forward, log_b, trans, alpha0, lengths)
        same = {"alpha": torch.equal(got[0], want[0]), "bp": torch.equal(got[1], want[1]),
                "alpha_sign": torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))}
        if composite is not None:
            got_d = kernel_runs(("trellis_dense_forward", "trellis_backtrace"),
                                tdn.dense_decode_pallas, log_b, trans, coefs, lengths)[0]
            want_d = plain_run(dense_decode, log_b, trans, coefs, lengths)
            same.update(scores=torch.equal(got_d[0], want_d[0]),
                        paths=torch.equal(got_d[1], want_d[1]))
        torch.cuda.synchronize()
        both = torch.isfinite(got[0]) & torch.isfinite(want[0])
        err = (got[0] - want[0])[both].abs().max().item() if both.any() else 0.0
        k4_err = max(k4_err, err)
        took = tdn.trellis_dense_branch(trans.shape[0])
        log("K4", case=name, B=log_b.shape[0], T=log_b.shape[1], S=trans.shape[0],
            branch=took, equal=json.dumps(same), max_abs_err=err)
        if not all(same.values()):
            raise SystemExit(f"K4 disagrees with dense_forward ({name})")
        if took != branch:
            raise SystemExit(f"K4 case {name} took the {took} branch, not {branch}")

    def rand_trans(s_r, b_r, t_r, zeros=False):
        """A random trans with -inf sprinkled in and an all -inf column,
        alpha0, integer log_b and lengths; zeros: every value a zero of
        random sign."""
        def zero(*shape):
            return torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5, -0.0, 0.0)

        if zeros:
            trans, alpha0, lb = zero(s_r, s_r), zero(b_r, s_r), zero(b_r, t_r, s_r)
        else:
            trans = torch.randn((s_r, s_r), generator=gen, device=dev)
            alpha0 = torch.randn((b_r, s_r), generator=gen, device=dev)
            alpha0[torch.rand((b_r, s_r), generator=gen, device=dev) < 0.3] = float("-inf")
            lb = torch.randint(-3, 1, (b_r, t_r, s_r), generator=gen, device=dev).float()
        trans[torch.rand((s_r, s_r), generator=gen, device=dev) < 0.4] = float("-inf")
        trans[:, 1] = float("-inf")
        ln = torch.randint(1, t_r + 1, (b_r,), generator=gen, device=dev, dtype=torch.int32)
        return lb, ln, trans, alpha0

    gen = torch.Generator(device=dev).manual_seed(11)
    k4_check("flagship-emissions", "block", decode["lb3"], decode["rand_len"], comp)
    c503 = random_composite(100, 3)
    k4_check("503-states", "cluster",
             3 * torch.randn((64, t_total, c503.num_states), generator=gen, device=dev),
             torch.randint(1, t_total + 1, (64,), generator=gen, device=dev,
                           dtype=torch.int32), c503)
    k4_check("integer-ties", "block", torch.randint(-3, 1, (64, 40, s), generator=gen,
                                                    device=dev).float(),
             torch.randint(1, 41, (64,), generator=gen, device=dev, dtype=torch.int32), comp)
    k4_check("B5-T1", "block", torch.randn((5, 1, s), generator=gen, device=dev),
             torch.ones(5, dtype=torch.int32, device=dev), comp)
    short = decode["rand_len"].clone()
    short[::5] = 1
    short[1::11] = 0
    k4_check("length-0-and-1-rows", "block", decode["lb3"], short, comp)
    # Each branch on random trans: one CTA (58, and 220 near the edge of
    # shared memory; 220 with B = 301, not a multiple of the utterances a
    # block carries), a cluster (300, 503; 503 with B = 37 and at T = 1), a
    # streamed slice (1000); signed zeros in the one-CTA and streamed ones.
    for name, branch, s_r, b_r, t_r, zeros in (
            ("inf-trans-58", "block", 58, 32, 60, False),
            ("inf-trans-220", "block", 220, 32, 60, False),
            ("220-ragged-B", "block", 220, 301, 12, False),
            ("inf-trans-300", "cluster", 300, 32, 60, False),
            ("503-ragged-B", "cluster", 503, 37, 40, False),
            ("503-T1", "cluster", 503, 5, 1, False),
            ("inf-trans-1000", "streamed", 1000, 8, 30, False),
            ("zeros-58", "block", 58, 16, 30, True),
            ("zeros-1000", "streamed", 1000, 3, 8, True)):
        lb, ln, trans, alpha0 = rand_trans(s_r, b_r, t_r, zeros)
        k4_check(name, branch, lb, ln, trans=trans, alpha0=alpha0)
    errs["trellis_dense_forward"] = k4_err

    # -- 13. K5 / K6 wrappers vs forward_fast --------------------------------
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    lb_s = decode["lb3"][..., :s].contiguous()
    want = plain_run(forward_fast, lb_s, pack_coefs(*topo, device=dev), comp.penalty,
                     decode["rand_len"])
    tsf.trellis_forward.launches = 0
    for name, fn in (("K5", tfast.viterbi_fast_forward_pallas),
                     ("K6", tlanes.viterbi_lanes_forward_pallas)):
        got = kernel_runs("trellis_forward", fn, lb_s, *topo, comp.penalty,
                          decode["rand_len"])[0]
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        log(name, wrapper=fn.__name__, B=b, T=t_total, S=s, bitwise_forward_fast=same)
        if not same:
            raise SystemExit(f"{name} ({fn.__name__}) disagrees with forward_fast")
    # One launch a wrapper call, each call made once under each poison.
    launches["trellis_forward"] = tsf.trellis_forward.launches // len(KERNEL_POISONS)

    # -- 14. decoder: backend "pallas" and the precision tiers ---------------
    signals, texts_sig = list(decode["signals"]), decode["texts_sig"]
    dec_p = ContinuousDecoder(flagship_models(), backend="pallas", **kw)
    counters = (em.emission, tdn.trellis_dense_forward, tsf.trellis_backtrace)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    texts_p = dec_p.predict_signal_batch(signals)
    torch.cuda.synchronize()
    pallas_launches = {c.__name__: c.launches for c in counters}
    texts_scan = ContinuousDecoder(flagship_models(), backend="scan",
                                   **kw).predict_signal_batch(signals)
    agree = float(np.mean([a == c for a, c in zip(texts_p, texts_sig)]))
    log("decode-pallas", launches=json.dumps(pallas_launches),
        transcripts_equal_scan=texts_p == texts_scan, agreement_scanfree=agree, B=len(texts_p))
    if not all(v > 0 for v in pallas_launches.values()):
        raise SystemExit(f"a kernel of the pallas backend never launched: {pallas_launches}")
    if texts_p != texts_scan:
        raise SystemExit("backend 'pallas' transcripts differ from backend 'scan'")
    launches["trellis_dense_forward"] = pallas_launches["trellis_dense_forward"]
    launches["trellis_backtrace"] = pallas_launches["trellis_backtrace"]
    tier_decoders = {tier: ContinuousDecoder(flagship_models(), emission_precision=tier, **kw)
                     for tier in em.PASSES}
    em.emission_split.launches = 0
    for tier in em.PASSES:
        before = em.emission_split.launches
        torch.cuda.synchronize()
        texts_t = tier_decoders[tier].predict_signal_batch(signals)
        torch.cuda.synchronize()
        n_launch = em.emission_split.launches - before
        log("decode-tier", tier=tier, backend=tier_decoders[tier].backend,
            emission_split_launches=n_launch,
            agreement_highest=float(np.mean([a == c for a, c in zip(texts_t, texts_sig)])))
        if n_launch == 0:
            raise SystemExit(f"the {tier} tier never launched the split kernel")
    launches["emission_split"] = em.emission_split.launches

    # -- 15. tier A/B on the phase-9 checkpoint ------------------------------
    ab = {}
    for tier in ("highest", *em.PASSES):
        dec_t = ContinuousDecoder(pipe["models"], penalty=-100.0, emissions="quad",
                                  emission_precision=tier, device=dev)
        ab[tier] = {split: dec_t.predict_batch(f) for split, (_t, f) in pipe["eval"].items()}
    for tier, preds in ab.items():
        for split, (truths, _f) in pipe["eval"].items():
            acc = float(np.mean([p == t for p, t in zip(preds[split], truths)]))
            agree = float(np.mean([p == h for p, h in zip(preds[split], ab["highest"][split])]))
            log("tier-ab", tier=tier, split=split, exact_seq_acc=acc, agreement_highest=agree,
                n=len(truths))
            if tier == "high" and split == "train_speakers" and acc < ACC_BAR:
                raise SystemExit(f"high-tier exact-sequence accuracy {acc} < {ACC_BAR}")

    # -- 16. timing: the new kernels, every kernel's yardsticks, end to end --
    # The emission kernels at the main-path shape (58 states), at the K=2
    # GMM width (S*K = 116, the same frames), at 503 states (phase 3's
    # N = 64 * 201) and at 5003 (N = 8 * 201), each on its tier's folded
    # operand (cached, as the decoder caches it) with its plain version,
    # its bound (the folded count; the unfolded one logged beside it), its
    # stage split (the timing variants of em.STAGES) and its library call:
    # one GEMM on each of two materialized layouts, x2 (K = D*D) against
    # nhp and x2's symmetric half (K = D(D+1)/2) against the folded nhp,
    # the faster kept. "highest" and "high" are held against the FP32 GEMM
    # (the one call that reaches "high"'s accuracy; bf16 does a third of
    # its passes), "default" against the one-pass bf16 GEMM, which is
    # logged beside "high" too.
    library, bounds, stage_split = {}, {}, {}
    c503e = random_composite(100, 1)
    c5003e = random_composite(1000, 2)
    g116 = gmm_width(comp)
    for suffix, frames_e, comp_e in (
            ("", frames, comp), ("_116", frames, g116),
            ("_503", frames[: 64 * t_total], c503e),
            ("_5003", frames[: 8 * t_total], c5003e)):
        s_e = comp_e.num_states
        packed_e = (decode["packed"] if not suffix else
                    em.pack_quad_params(comp_e.means, comp_e.covariances,
                                        -(-s_e // 128) * 128, device=dev))
        nhp, lin, const = packed_e
        hi, lo = em.split_hi_lo(nhp)
        n_e, sp_e = frames_e.shape[0], nhp.shape[1]
        f_e = {tier: em.fold_quad_params(nhp, lin, const, tier, s_e)
               for tier in ("highest", *em.PASSES)}
        timings["emission" + suffix] = (
            device_ms(lambda: em.emission(frames_e, nhp, lin, const, s_e, sp_e,
                                        folded=f_e["highest"])),
            cuda_ms(lambda: em.emission_plain(frames_e, nhp, lin, const), reps=3))
        for tier, passes in em.PASSES.items():
            timings[f"emission_split_{tier}{suffix}"] = (
                device_ms(lambda: em.emission_split(frames_e, None, None, lin, const, s_e, sp_e,
                                                  passes, folded=f_e[tier])),
                cuda_ms(lambda: em.emission_split_plain(frames_e, hi, lo, lin, const, passes),
                        reps=3))
        for tier, variants in em.STAGES.items():
            name = ("emission" if tier == "highest" else f"emission_split_{tier}") + suffix
            split = {"full_ms": timings[name][0]}
            for stage in variants:
                split[f"{stage}_ms"] = device_ms(
                    lambda: em.emission_stage(frames_e, const, f_e[tier], stage))
            stage_split[name] = split
            log("timing", stage_split=name, N=n_e, S=s_e, **split)
        layouts = {"x2": ((frames_e[:, :, None] * frames_e[:, None, :]).reshape(n_e, d * d),
                          nhp),
                   "x2_sym": (em.x2_sym(frames_e), em.fold_nhp(nhp, d))}
        lib_ms = {}
        for lay, (a, w) in layouts.items():
            lib_ms[("fp32", lay)] = device_ms(lambda: torch.matmul(a, w))
            a, w = a.to(torch.bfloat16), w.to(torch.bfloat16)
            lib_ms[("bf16", lay)] = device_ms(lambda: torch.matmul(a, w))
        del layouts, a, w
        for kind, names in (("fp32", ["emission", "emission_split_high"]),
                            ("bf16", ["emission_split_default"])):
            log("timing", library=kind, suffix=suffix or "main", N=n_e, S=s_e,
                **{f"{lay}_ms": lib_ms[(kind, lay)] for lay in ("x2", "x2_sym")},
                yardstick_of=",".join(names))
            for name in names:
                library[name + suffix] = min(lib_ms[(kind, "x2")], lib_ms[(kind, "x2_sym")])
        for tier in ("highest", *em.PASSES):
            name = ("emission" if tier == "highest" else f"emission_split_{tier}") + suffix
            bounds[name] = emission_bound(n_e, d, s_e, sp_e, tier)
            log("timing", bound=name, folded_ms=bounds[name][0], folded_by=bounds[name][1],
                unfolded_ms=emission_bound(n_e, d, s_e, sp_e, tier, folded=False)[0],
                fp32_linear_ms=emission_bound(n_e, d, s_e, sp_e, tier, fp32_linear=True)[0])
        del f_e, hi, lo, packed_e, nhp, lin, const

    # K4 at the flagship, at 503 states (B = 64; the cluster branch) and,
    # logged only, at 1000 (B = 16; the streamed branch).
    lengths = decode["n_frames"]
    alpha0 = torch.where(dec_p._coefs[4] > 0, decode["lb3"][:, 0, :s] + dec_p._coefs[6],
                         float("-inf"))
    lb503 = 3 * torch.randn((64, t_total, c503.num_states), generator=gen, device=dev)
    t503 = composite_transition_matrix(c503.log_a, c503.lower_of_state, c503.is_entry,
                                       c503.is_exit, c503.penalty, device=dev)
    lb1k, _ln, tr1k, a1k = rand_trans(1000, 16, t_total)
    k4_shapes = {
        "trellis_dense_forward": (decode["lb3"], dec_p._trans, alpha0, lengths),
        "trellis_dense_forward_503": (
            lb503, t503, torch.where(torch.as_tensor(c503.is_entry, device=dev),
                                     lb503[:, 0], float("-inf")),
            torch.full((64,), t_total, dtype=torch.int32, device=dev)),
        "trellis_dense_forward_1000": (lb1k, tr1k, a1k,
                                       torch.full((16,), t_total, dtype=torch.int32,
                                                  device=dev)),
    }
    for name, args in k4_shapes.items():
        timings[name] = (device_ms(lambda: tdn.trellis_dense_forward(*args)),
                         cuda_ms(lambda: dense_forward(*args), reps=3))
        log_b_k, trans_k, _a, lengths_k = args
        bounds[name] = dense_bound(log_b_k.shape[0], t_total, trans_k.shape[0], lengths_k)

    # The scan-free pair at phase 6's inputs and K3 at phase 10's.
    live = int(lengths.clamp(max=t_total).sum().item())
    bounds["trellis_forward"] = bound(4 * live * s + 4 * b * t_total * s
                                      + 4 * (b * s + 8 * s + b),
                                      [(6 * b * (t_total - 1) * s, PEAK_FP32_ALU)])
    bounds["trellis_backtrace"] = bound(4 * (live - b) + 4 * b * t_total + 8 * b)
    # Decode mode: the live log_b rows in, paths and scores out, coefficients
    # and lengths; the steps these lengths run.
    bounds["trellis_decode"] = bound(4 * live * s + 4 * b * t_total + 4 * b + 4 * 8 * s
                                     + 4 * b, [(6 * (live - b) * s, PEAK_FP32_ALU)])
    lb_k3, k3_lengths = pipe["k3_args"][0], pipe["k3_args"][-1]
    b3, t3, s3 = lb_k3.shape
    live3 = int(k3_lengths.clamp(max=t3).sum().item())
    bounds["trellis_backtrace_k3"] = bound(4 * (live3 - b3) + 4 * b3 * t3 + 8 * b3)
    bounds["trellis_banded_forward"] = bound(4 * live3 * s3 + 4 * b3 * t3 * s3 + 16 * b3 * s3
                                             + 4 * b3,
                                             [(6 * b3 * (t3 - 1) * s3, PEAK_FP32_ALU)])
    # The sentence decode mode: the live log_b rows, the coefficient rows,
    # lengths and final states in, paths and scores out; the steps these
    # lengths run.
    steps3 = int(k3_lengths.clamp(min=1, max=t3).sum().item()) - b3
    bounds["trellis_banded_decode"] = bound(4 * live3 * s3 + 12 * b3 * s3 + 8 * b3
                                            + 4 * b3 * t3 + 4 * b3,
                                            [(6 * steps3 * s3, PEAK_FP32_ALU)])
    timings["emission_split"] = timings["emission_split_high"]
    library["emission_split"] = library["emission_split_high"]
    bounds["emission_split"] = bounds["emission_split_high"]
    yardsticks = {k: (library.get(k), *bounds[k]) for k in bounds}
    emission_rows = [("emission" if t == "highest" else f"emission_split_{t}") + suffix
                     for suffix in ("", "_116", "_503", "_5003")
                     for t in ("highest", *em.PASSES)]
    for name in (*emission_rows, "trellis_dense_forward", "trellis_dense_forward_503",
                 "trellis_dense_forward_1000", "trellis_decode", "trellis_forward",
                 "trellis_backtrace", "trellis_banded_decode", "trellis_banded_forward",
                 "trellis_backtrace_k3"):
        ms, plain_ms = timings[name]
        lib_ms, b_ms, b_by = yardsticks[name]
        log("timing", kernel=name, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by)

    dec_sf, dec_high = decode["dec"], tier_decoders["high"]
    dec_high_p = ContinuousDecoder(flagship_models(), backend="pallas",
                                   emission_precision="high", **kw)
    paths = {"scanfree": dec_sf, "pallas": dec_p, "high": dec_high,
             "pallas+high": dec_high_p}
    sig_dev, ns_dev = decode["sig_dev"], decode["ns_dev"]
    for dec_x in paths.values():
        dec_x.decode_signals(sig_dev, ns_dev)
    e2e = {}
    for name in (*paths, *reversed(paths)):
        e2e[name] = min(e2e.get(name, float("inf")),
                        window(lambda: paths[name].decode_signals(sig_dev, ns_dev)))
    for name, ms in e2e.items():
        log("timing", path=name, ms_per_batch=ms, utt_per_s=len(signals) / ms * 1e3)
    return yardsticks


def stream_steps(rng, b, c, t_max, n_steps, compact):
    """Pool steps as host (slot_ids, t, valid) rows: staggered starts,
    uneven chunks of 1..c frames, idle slots, slot 0 recycled halfway;
    compact rows are the fed slots padded to a power of two with slot b and
    valid 0, dense rows one a slot (valid 0 when idle)."""
    clock = np.zeros(b, np.int64)
    start = rng.integers(0, 3, b)
    for step in range(n_steps):
        if step == n_steps // 2:
            clock[0] = 0
        fed = [s for s in range(b)
               if step >= start[s] and rng.random() < 0.7 and clock[s] < t_max]
        valid = np.zeros(b, np.int64)
        for s in fed:
            valid[s] = min(int(rng.integers(1, c + 1)), t_max - clock[s])
        if compact:
            r = max(8, 1 << max(len(fed) - 1, 0).bit_length())
            slot_ids = np.full(r, b, np.int32)
            t = np.zeros(r, np.int32)
            v = np.zeros(r, np.int32)
            slot_ids[: len(fed)] = fed
            t[: len(fed)] = clock[fed]
            v[: len(fed)] = valid[fed]
        else:
            slot_ids, t, v = (np.arange(b, dtype=np.int32), clock.astype(np.int32),
                              valid.astype(np.int32))
        yield slot_ids, t, v
        clock += valid


def trace(fn, n=5):
    """A torch.profiler trace of n calls of fn(): host wall ms a call, device
    busy ms a call (kernels and copies), and the six torch ops with the most
    host time (self, ms a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    avgs = prof.key_averages()
    busy = sum(e.self_device_time_total for e in avgs if e.device_type == DeviceType.CUDA)
    top = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    return {"wall_ms": wall, "device_busy_ms": busy / n / 1e3,
            "top_host_ops_ms": {e.key: round(e.self_cpu_time_total / n / 1e3, 4) for e in top}}


def stream_bound(rows, valid, s, ring_bytes):
    """bound() of one stream-mode step: the live rows' emissions in, their
    alpha read and written, one ring row a live frame out, coefficients and
    row ids; an add and a compare per (candidate, state), 6 a step, at
    PEAK_FP32_ALU over the live frames."""
    frames = rows * valid
    return bound(4 * frames * s + 8 * rows * s + ring_bytes * frames * s + 32 * s + 12 * rows,
                 [(6 * frames * s, PEAK_FP32_ALU)])


def stream_phase(dev, launches, timings, errs, yardsticks):
    """Phase 17: the serving pool's step on the card: the stream mode, the
    dense step through K4 and K2-bt on the ring against their plain
    versions, their times, and whole banded pools against CPU pools."""
    from cs304_tpu_torch.device import upload
    from cs304_tpu_torch.models.hmm import flagship_composite
    from cs304_tpu_torch.ops import streaming_batch as sb
    from cs304_tpu_torch.ops.cuda import trellis_dense as tdn
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.cuda import trellis_stream as tst
    from cs304_tpu_torch.ops.viterbi import (
        backtrace_batch,
        composite_transition_matrix,
        first_max,
        pack_coefs,
    )

    flag, c503, c5003 = flagship_composite(), random_composite(100, 3), random_composite(1000, 3)
    c373 = random_composite(74, 3)  # the phone tiers' width: 3 warps of 4 states
    stream_err = 0.0

    def stream_check(name, comp, b, t_max, ring_dtype, penalty, compact, ties, dense=False):
        """The stream mode (or, dense, the K4 step) over 12 pool steps of up
        to 32 frames against the plain step on CPU copies, compared after
        every step. Returns the card's alpha, ring and clocks."""
        nonlocal stream_err
        s = comp.num_states
        topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
        coefs = pack_coefs(*topo, device=dev)
        trans = composite_transition_matrix(*topo, penalty, device=dev)
        coefs_p, trans_p = coefs.cpu(), trans.cpu()
        alpha = torch.full((b, s), float("-inf"), device=dev)
        ring = torch.full((b, t_max, s), -1, dtype=ring_dtype, device=dev)
        alpha_p, ring_p = alpha.cpu(), ring.cpu()
        rng = np.random.default_rng(s + b)
        clock = np.zeros(b, np.int64)
        same = {"alpha": True, "alpha_sign": True, "ring": True}
        for slot_ids, t, valid in stream_steps(rng, b, 32, t_max, 12, compact):
            shape = (len(slot_ids), 32, s)
            lb = (rng.integers(-3, 1, shape) if ties else 3 * rng.normal(size=shape))
            lb = torch.as_tensor(lb.astype(np.float32))
            # The card's step on poisoned copies, the plain step with the rows
            # it writes under the plain poison.
            poison_rows(ring_p, slot_ids, t, valid, PLAIN_POISON)
            if dense:
                alpha, ring = stream_step_runs(
                    "trellis_dense_forward", lambda a, r: tst.dense_stream_advance(
                        a, r, slot_ids, t, valid, lb.to(dev), trans, coefs),
                    alpha, ring, slot_ids, t, valid)
                if compact:
                    sb._advance_compact(alpha_p, ring_p, slot_ids, t, valid, lb, coefs_p[6],
                                        coefs_p[4] > 0, trans=trans_p)
                else:
                    sb._advance(alpha_p, ring_p, t, valid, lb, trans_p, coefs_p[6],
                                coefs_p[4] > 0)
            else:
                rows = [upload(x, dev) for x in (slot_ids, t, valid)]
                alpha, ring = stream_step_runs(
                    "trellis_stream", lambda a, r: tst.stream_advance(
                        a, r, *rows, lb.to(dev), coefs, penalty),
                    alpha, ring, slot_ids, t, valid)
                sb._advance_compact(alpha_p, ring_p, slot_ids, t, valid, lb, coefs_p[6],
                                    coefs_p[4] > 0, coeffs=sb._coeffs_of(coefs_p, penalty))
            torch.cuda.synchronize()
            got_a = alpha.cpu()
            same["alpha"] &= torch.equal(got_a, alpha_p)
            same["alpha_sign"] &= torch.equal(torch.signbit(got_a), torch.signbit(alpha_p))
            same["ring"] &= torch.equal(ring.cpu(), ring_p)
            both = torch.isfinite(got_a) & torch.isfinite(alpha_p)
            if both.any():
                stream_err = max(stream_err, (got_a - alpha_p)[both].abs().max().item())
            keep = slot_ids < b
            clock[slot_ids[keep]] = t[keep] + valid[keep]
        log("stream", case=name, kernel="K4" if dense else "stream_mode", S=s, B=b,
            T_max=t_max, ring=str(ring_dtype).split(".")[-1], penalty=penalty,
            rows="compact" if compact else "dense", ties=ties, equal=json.dumps(same))
        if not all(same.values()):
            raise SystemExit(f"the pool step disagrees with its plain version ({name})")
        return alpha, ring, clock

    cases = {}
    for name, comp, b, t_max, ring_dtype, penalty, compact, ties in (
            ("flagship-int8-compact", flag, 64, 400, torch.int8, -100.0, True, False),
            ("flagship-int8-dense-ties", flag, 64, 400, torch.int8, -100.0, False, True),
            ("flagship-int8-zero-penalty", flag, 64, 400, torch.int8, 0.0, True, True),
            ("373-int32-compact", c373, 16, 300, torch.int32, -100.0, True, False),
            ("503-int32-compact", c503, 16, 300, torch.int32, -100.0, True, False),
            ("503-int32-dense-zero-penalty", c503, 16, 300, torch.int32, 0.0, False, True),
            ("5003-int32-compact", c5003, 8, 200, torch.int32, -100.0, True, False),
            ("5003-int32-dense-ties", c5003, 8, 200, torch.int32, -100.0, False, True)):
        cases[name] = stream_check(name, comp, b, t_max, ring_dtype, penalty, compact, ties)
    for compact in (False, True):
        stream_check(f"flagship-k4-{'compact' if compact else 'dense'}", flag, 64, 400,
                     torch.int8, -100.0, compact, True, dense=True)
    # K2-bt walking ring[:, :T] in place, int8 (58 states) and int32 (503).
    for name, t_bucket in (("flagship-int8-compact", 256), ("503-int32-compact", 256)):
        alpha, ring, clock = cases[name]
        fills = torch.as_tensor(np.minimum(clock, t_bucket).astype(np.int32), device=dev)
        _, best = first_max(alpha, torch.ones(alpha.shape[1], dtype=torch.bool, device=dev))
        got = kernel_runs("trellis_backtrace", tsf.trellis_backtrace, ring[:, :t_bucket], best,
                          fills, quirk=False)[0]
        want = plain_run(backtrace_batch, ring[:, :t_bucket].cpu().to(torch.int32), best.cpu(),
                         fills.cpu(), quirk=False)
        torch.cuda.synchronize()
        same = torch.equal(got.cpu(), want)
        log("stream", case=f"K2-bt-ring-{name}", T=t_bucket, ring=str(ring.dtype),
            bitwise_backtrace_batch=same)
        if not same:
            raise SystemExit(f"K2-bt on the ring disagrees with backtrace_batch ({name})")
    errs["trellis_stream"] = stream_err

    # -- times at streaming_bench.py's shapes (chunk 16, max_frames 1024, 58
    # states; every slot fed, clocks past 0) and 256 slots at 503 states.
    def kernel_times(comp, b, t_max, ring_dtype, chunk=16):
        s = comp.num_states
        topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
        coefs = pack_coefs(*topo, device=dev)
        trans = composite_transition_matrix(*topo, comp.penalty, device=dev)
        gen = torch.Generator(device=dev).manual_seed(b)
        alpha = 3 * torch.randn((b, s), generator=gen, device=dev)
        ring = torch.full((b, t_max, s), -1, dtype=ring_dtype, device=dev)
        lb = 3 * torch.randn((b, chunk, s), generator=gen, device=dev)
        ids_h, t_h = np.arange(b, dtype=np.int32), np.full(b, 100, np.int32)
        v_h = np.full(b, chunk, np.int32)
        ids, t_d, v_d = (torch.as_tensor(x, device=dev) for x in (ids_h, t_h, v_h))
        out = {"stream": device_ms(lambda: tst.stream_advance(alpha, ring, ids, t_d, v_d, lb,
                                                             coefs, comp.penalty)),
               "stream_plain": cuda_ms(lambda: sb._advance_compact(
                   alpha, ring, ids, t_d, v_d, lb, coefs[6], coefs[4] > 0,
                   coeffs=sb._coeffs_of(coefs, comp.penalty)), reps=3)}
        if s <= 127:
            lb17 = 3 * torch.randn((b, chunk + 1, s), generator=gen, device=dev)
            lens = torch.full((b,), chunk + 1, dtype=torch.int32, device=dev)
            out["k4"] = device_ms(lambda: tdn.trellis_dense_forward(lb17, trans, alpha, lens))
            out["k4_step_eager"] = cuda_ms(lambda: tst.dense_stream_advance(
                alpha, ring, ids_h, t_h, v_h, lb, trans, coefs))
            fills = torch.full((b,), 500, dtype=torch.int32, device=dev)
            ring[:, :512] = torch.randint(0, s, (b, 512, s), generator=gen, device=dev).to(
                ring_dtype)
            best = torch.zeros(b, dtype=torch.int32, device=dev)
            out["k2bt_ring"] = device_ms(lambda: tsf.trellis_backtrace(
                ring[:, :512], best, fills, quirk=False))
        return out

    def fed_pool(comp, b, t_max, step_impl, chunk=16):
        """A pool of b slots, warmed by one step and every slot restarted,
        and 4 feeds of a chunk for every slot (streaming_bench.py's)."""
        pool = sb.BatchedStreamingComposite(comp, num_slots=b, chunk_size=chunk,
                                            max_frames=t_max, step_impl=step_impl, device=dev)
        rng = np.random.default_rng(0)
        slots = [pool.start() for _ in range(b)]
        feeds = [{s: rng.normal(size=(chunk, 39)).astype(np.float32) for s in slots}
                 for _ in range(4)]
        pool.step(feeds[0])
        torch.cuda.synchronize()
        for s in slots:
            pool.release(s)
        for _ in range(b):
            pool.start()
        return pool, feeds

    def pool_step_ms(comp, b, t_max, step_impl, chunk=16, steps=20):
        """streaming_bench.py's step: host wall ms of pool.step() with every
        slot fed a chunk (upload, emissions, trellis), the window closed by
        a synchronize."""
        pool, feeds = fed_pool(comp, b, t_max, step_impl, chunk)
        steps = min(steps, t_max // chunk - 1)
        t0 = time.perf_counter()
        for i in range(steps):
            pool.step(feeds[i % 4])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for comp, b, t_max, ring_dtype in ((flag, 128, 1024, torch.int8), (flag, 512, 1024, torch.int8),
                                       (flag, 1024, 1024, torch.int8),
                                       (c503, 256, 2048, torch.int32),
                                       (c5003, 64, 512, torch.int32)):
        s = comp.num_states
        kt = kernel_times(comp, b, t_max, ring_dtype)
        rb = 1 if ring_dtype == torch.int8 else 4
        b_ms, b_by = stream_bound(b, 16, s, rb)
        steps = {impl: pool_step_ms(comp, b, t_max, impl)
                 for impl in (("dense", "banded") if s <= 127 else ("banded",))}
        build = stream_build(s, rb)
        log("timing", what="pool step", S=s, slots=b, chunk=16, T_max=t_max,
            ring=str(ring_dtype).split(".")[-1], card=repr(smi),
            stream_ms=kt["stream"], stream_plain_ms=kt["stream_plain"],
            stream_bound_ms=b_ms, stream_bound_by=b_by,
            stream_us_per_step=kt["stream"] / 16 * 1e3,
            build_registers=build.get("registers"), build_spill_stores=build.get("spill_stores"),
            build_spill_loads=build.get("spill_loads"),
            k4_ms=kt.get("k4"), k4_step_eager_ms=kt.get("k4_step_eager"),
            k2bt_ring_ms=kt.get("k2bt_ring"),
            **{f"pool_step_ms_{k}": v for k, v in steps.items()},
            **{f"realtime_streams_{k}": int(b * 16 / (v * 1e-3 * 100))
               for k, v in steps.items()})
        if s <= 127 and b == 512:
            timings["trellis_stream"] = (kt["stream"], kt["stream_plain"])
            yardsticks["trellis_stream"] = (None, b_ms, b_by)
            # Where a pool step's time goes (the dense step's gather and
            # scatter against the stream mode's one launch).
            for impl in ("dense", "banded"):
                pool, feeds = fed_pool(comp, b, t_max, impl)
                it = iter(range(10 ** 6))
                tr = trace(lambda: pool.step(feeds[next(it) % 4]))
                log("trace", what=f"pool step {impl}", S=s, slots=b, chunk=16,
                    wall_ms=tr["wall_ms"], device_busy_ms=tr["device_busy_ms"],
                    top_host_ops_ms=json.dumps(tr["top_host_ops_ms"]))
                del pool
        del kt
        torch.cuda.empty_cache()

    # -- whole banded pools on the card against the same pools on the CPU ---
    def utterances(comp, n, rng):
        means = np.asarray(comp.means)
        picks = (means[rng.integers(0, len(means), int(rng.integers(40, 300)))]
                 for _ in range(n))
        return [(m + rng.normal(0, 0.5, m.shape)).astype(np.float32) for m in picks]

    pool_launches = 0
    for comp in (flag, c503):
        rng = np.random.default_rng(comp.num_states)
        utts = utterances(comp, 12, rng)
        pools = {d: sb.BatchedStreamingComposite(comp, num_slots=16, chunk_size=32,
                                                 max_frames=512, step_impl="banded", device=d)
                 for d in ("cuda", "cpu")}
        slots = {d: [p.start() for _ in utts] for d, p in pools.items()}
        tst.stream_advance.launches = 0
        tsf.trellis_backtrace.launches = 0
        polls, agree = 0, 0
        cursors, step = [0] * len(utts), 0
        while any(cursors[i] < len(u) for i, u in enumerate(utts)):
            feeds = {}
            for i, u in enumerate(utts):
                if step >= i // 3 and cursors[i] < len(u):
                    n = int(rng.integers(1, 33))
                    feeds[i] = u[cursors[i]: cursors[i] + n]
                    cursors[i] += len(feeds[i])
            texts = {}
            for d, p in pools.items():
                p.step({slots[d][i]: f for i, f in feeds.items()}, partials=step % 2 == 0)
                got = p.partial_texts(slots[d], stale_ok=step % 3 == 0)
                texts[d] = [got[s] for s in slots[d]]
            polls += len(utts)
            agree += sum(a == c for a, c in zip(texts["cuda"], texts["cpu"]))
            step += 1
        fin = {d: p.finalize(slots[d]) for d, p in pools.items()}
        last = {d: p.partial_texts(slots[d]) for d, p in pools.items()}
        torch.cuda.synchronize()
        n_stream, n_bt = tst.stream_advance.launches, tsf.trellis_backtrace.launches
        pool_launches += n_stream
        ok_texts = all(fin["cuda"][a][1] == fin["cpu"][c][1] and last["cuda"][a] == last["cpu"][c]
                       for a, c in zip(slots["cuda"], slots["cpu"]))
        ok_scores = all(abs(fin["cuda"][a][0] - fin["cpu"][c][0])
                        <= 1e-5 * abs(fin["cpu"][c][0])
                        for a, c in zip(slots["cuda"], slots["cpu"]))
        log("stream", pool=f"banded S={comp.num_states}", steps=step,
            launches=json.dumps({"stream_advance": n_stream, "trellis_backtrace": n_bt}),
            finals_equal_cpu=ok_texts, scores_within_rel_1e_5=ok_scores,
            poll_agreement=agree / polls, sample=repr([fin["cuda"][s][1] for s in
                                                       slots["cuda"][:3]]))
        if not (ok_texts and ok_scores):
            raise SystemExit(f"the banded pool on the card differs from the CPU pool "
                             f"(S={comp.num_states})")
        if n_stream == 0 or n_bt == 0:
            raise SystemExit(f"the banded pool never launched the stream mode or K2-bt: "
                             f"{n_stream}, {n_bt}")
        del pools
        torch.cuda.empty_cache()
    launches["trellis_stream"] = pool_launches


SERVE_SR, SERVE_SESSIONS, SERVE_SECONDS, SERVE_CHUNK = 16000, 64, 3.0, 1600


def serving_traffic(corpus):
    """benchmarks/serving_bench.py:67-78's traffic: 64 sessions of 3 s
    (noise, two synthetic sentences, noise), and a warm-up utterance."""
    rng = np.random.default_rng(0)
    sr = SERVE_SR
    transcripts = ["375", "186Z", "54321", "12", "9O2", "4Z"]

    def session_audio(i):
        pieces = [rng.normal(0, 20.0, int(0.3 * sr)).astype(np.float32)]
        for j in range(2):
            pieces.append(corpus.sentence_audio(transcripts[(i + j) % len(transcripts)], i % 6,
                                                jitter_seed=j))
            pieces.append(rng.normal(0, 20.0, int(0.4 * sr)).astype(np.float32))
        return np.concatenate(pieces)[: int(SERVE_SECONDS * sr)]

    audio = [session_audio(i) for i in range(SERVE_SESSIONS)]
    warm = np.concatenate([corpus.sentence_audio("375", 0),
                           rng.normal(0, 20.0, int(0.4 * sr)).astype(np.float32)])
    return audio, warm


def drive_sessions(pool, which, audio, warm, chunk=SERVE_CHUNK):
    """Feed sessions `which` their audio in 100 ms chunks after a warm-up
    session, polling partials after each feed(). -> (results per session,
    polls, wall s, ms per round)."""
    scratch = pool.open()
    for off in range(0, len(warm), chunk):
        pool.feed({scratch: warm[off: off + chunk]})
        pool.partials([scratch])
    pool.close(scratch)
    sessions = [pool.open() for _ in which]
    results = {s: [] for s in sessions}
    polls = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    longest = max(len(audio[i]) for i in which)
    rounds = 0
    for off in range(0, longest, chunk):
        done = pool.feed({s: audio[i][off: off + chunk]
                          for s, i in zip(sessions, which) if off < len(audio[i])})
        for s, rs in done.items():
            results[s] += rs
        polls.append(pool.partials(sessions))
        rounds += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([results[s] for s in sessions], [[p[s] for s in sessions] for p in polls],
            wall, wall / rounds * 1e3)


def serving_phase(dev, pipe):
    """Phase 18: ServingSessionPool on the card with serving_bench.py's
    traffic, on phase 9's trained models."""
    from cs304_tpu_torch import native
    from cs304_tpu_torch.audio.capture import Segmentation, SegmentationDone
    from cs304_tpu_torch.models.decoder import ContinuousDecoder
    from cs304_tpu_torch.ops import streaming_batch as sb
    from cs304_tpu_torch.ops.cuda import trellis_dense as tdn
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.cuda import trellis_stream as tst
    from cs304_tpu_torch.serving import ServingSessionPool

    models, corpus = pipe["models"], pipe["corpus"]
    sr, n_sessions, seconds, chunk = SERVE_SR, SERVE_SESSIONS, SERVE_SECONDS, SERVE_CHUNK
    audio, warm = serving_traffic(corpus)

    def drive(pool, which):
        return drive_sessions(pool, which, audio, warm)

    # No plain step may run on a CUDA tensor: count calls of the plain
    # versions the wrappers reach, by CUDA argument.
    plain_on_card = {}

    counters = {"trellis_dense_forward": tdn.trellis_dense_forward,
                "trellis_backtrace": tsf.trellis_backtrace,
                "trellis_decode": tsf.scanfree_decode, "trellis_stream": tst.stream_advance}
    saved = [guard(plain_on_card, m, n)
             for m, n in ((sb, "_advance"), (sb, "_advance_banded"), (sb, "_advance_compact"),
                          (tdn, "dense_forward"), (tsf, "backtrace_batch"),
                          (tsf, "forward_fast"))]
    try:
        pool = ServingSessionPool(models, num_slots=64, max_frames=4096, device="cuda")
        for c in counters.values():
            c.launches = 0
        results, polls, wall, round_ms = drive(pool, range(n_sessions))
        serve_launches = {n: c.launches for n, c in counters.items()}
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    audio_s = sum(len(a) for a in audio) / sr

    # Reference: per-frame endpointing (Segmentation.routine, one 320-sample
    # frame a call), every endpointed signal decoded by a fresh decoder.
    signals, owner = [], []
    for i, a in enumerate(audio):
        seg = Segmentation(stream=None, silence_duration_threshold=0.2)
        for f in range(len(a) // 320):
            seg.audio_cache.put(a[f * 320: (f + 1) * 320])
            try:
                seg.routine()
            except SegmentationDone:
                signals.append(seg.result_signal())
                owner.append(i)
                seg = Segmentation(stream=None, silence_duration_threshold=0.2)
    ref = ContinuousDecoder(models, penalty=-100.0, device="cuda").predict_signal_batch(signals)
    want = [[] for _ in audio]
    for i, sig, text in zip(owner, signals, ref):
        want[i].append((text, len(sig)))
    got = [[(r.text, r.num_samples) for r in rs] for rs in results]
    finals_ok = got == want
    n_finals = sum(len(rs) for rs in results)

    # The same audio on the CPU for 4 sessions.
    cpu = ServingSessionPool(models, num_slots=64, max_frames=4096, device="cpu")
    results_c, polls_c, _w, _r = drive(cpu, range(4))
    cross = [[(r.text, r.last_partial) for r in rs] for rs in results_c]
    cross_ok = cross == [[(r.text, r.last_partial) for r in rs] for rs in results[:4]]
    pairs = [(a, c) for pc, pk in zip(polls_c, polls) for a, c in zip(pk[:4], pc)]
    agreement = float(np.mean([a == c for a, c in pairs]))

    # Finals only (partials off): the headline of serving_bench.py.
    finals_only = ServingSessionPool(models, num_slots=64, max_frames=4096, partials=False,
                                     device="cuda")
    _res, _polls, wall_f, round_ms_f = drive(finals_only, range(n_sessions))
    log("serving", sessions=n_sessions, audio_s=f"{audio_s:.1f}", finals=n_finals,
        finals_equal_predict_signal_batch=finals_ok, cpu_cross_check_equal=cross_ok,
        partial_poll_agreement_cpu=agreement, polls=len(pairs),
        launches=json.dumps(serve_launches), plain_steps_on_card=json.dumps(plain_on_card),
        has_native=native.HAS_NATIVE, sample=repr(got[0]))
    log("timing", what="serving (partials pipelined, polled every feed)", wall_s=wall,
        realtime_sessions=audio_s / wall, ms_per_feed_round=round_ms)
    log("timing", what="serving (finals only)", wall_s=wall_f,
        realtime_sessions=audio_s / wall_f, ms_per_feed_round=round_ms_f)

    # Where a feed() round's time goes: a torch.profiler trace of 10 rounds
    # (the card's busy share) and cProfile of the next 10 (host functions;
    # cProfile slows the Python it counts, so read shares, not times).
    import cProfile
    import pstats

    traced = ServingSessionPool(models, num_slots=64, max_frames=4096, device="cuda")
    sessions = [traced.open() for _ in range(n_sessions)]
    offsets = iter(range(0, int(seconds * sr), chunk))

    def one_round():
        off = next(offsets)
        traced.feed({s: audio[i][off: off + chunk] for i, s in enumerate(sessions)})
        traced.partials(sessions)

    tr = trace(one_round, n=10)
    log("trace", what=f"serving feed() round, {n_sessions} sessions, partials polled",
        wall_ms=tr["wall_ms"], device_busy_ms=tr["device_busy_ms"],
        device_idle_share=1 - tr["device_busy_ms"] / tr["wall_ms"],
        top_host_ops_ms=json.dumps(tr["top_host_ops_ms"]))
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(9):
        one_round()
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: kv[1][2], reverse=True)
    total = sum(v[2] for _k, v in rows)
    log("trace", what="serving host functions (cProfile, 9 rounds, share of tottime)",
        top=json.dumps({f"{k[0].rsplit('/', 1)[-1]}:{k[2]}": round(v[2] / total, 4)
                        for k, v in rows[:10]}))
    if not finals_ok or n_finals < n_sessions:
        raise SystemExit(f"serving finals differ from predict_signal_batch on the endpointed "
                         f"signals ({n_finals} finals)")
    if not cross_ok or agreement < 0.95:
        raise SystemExit(f"serving on the card differs from the CPU run (finals "
                         f"{cross_ok}, partial agreement {agreement})")
    if not all(serve_launches[k] > 0 for k in ("trellis_dense_forward", "trellis_backtrace",
                                                "trellis_decode")):
        raise SystemExit(f"a kernel of the serving path never launched: {serve_launches}")
    if plain_on_card:
        raise SystemExit(f"a plain step ran on a CUDA tensor while serving: {plain_on_card}")


def fb_bound(b, t, s, lengths):
    """bound() of one sentence forward-backward: every log_b row a chain
    reads (rows below min(length, T)), the coefficients, lengths and finals
    in; alpha and beta (every row) and ll out; 16 FP32 operations (adds,
    compares, three exp and a log counted as one each) per (chain step,
    state) in each direction, over the steps these lengths need."""
    live = int(lengths.clamp(min=0, max=t).sum().item())
    steps = int((lengths.clamp(min=1, max=t) - 1).sum().item())
    return bound(4 * live * s + 12 * b * s + 8 * b + 8 * b * t * s + 4 * b,
                 [(2 * 16 * steps * s, PEAK_FP32_ALU)])


def fb_posteriors_bound(b, t, s, lengths):
    """bound() of one Baum-Welch E-step: the live log_b rows, the
    coefficients, lengths and finals in; gamma (every row), xi (B, 3, S) and
    ll out; per (chain step, state) 15 FP32 operations in each direction
    (adds, compares, two exp and a log counted as one each), per (pair,
    state) 15 for the three xi terms (three adds, an exp and the sum's add
    each), per (live row, state) 3 for gamma, over what these lengths need."""
    live = int(lengths.clamp(min=0, max=t).sum().item())
    steps = int((lengths.clamp(min=1, max=t) - 1).sum().item())
    return bound(4 * live * s + 12 * b * s + 8 * b + 4 * b * t * s + 12 * b * s + 4 * b,
                 [((2 * 15 + 15) * steps * s + 3 * live * s, PEAK_FP32_ALU)])


def fb_problem(dev, b, t, s, seed, zero_length=False):
    """A sentence forward-backward problem drawn on the CPU from a seed and
    moved to the card (tests/test_torch_cuda_kernels.py:_fb_case): -inf
    sprinkled in odd rows into log_b, c1 and c2 independently (walls, dead
    utterances over long T), in even rows into c1 and c2, never both at one
    state; finals in the top
    quarter of [0, min(S - 1, 1.5 (length - 1))], row 0's at its top, rows
    3, 11, ... past the band (ll = -inf)."""
    gen = torch.Generator().manual_seed(seed)
    log_b = 2 * torch.randn((b, t, s), generator=gen)
    cs = [0.5 * torch.randn((b, s), generator=gen) for _ in range(3)]
    cs[1][:, :1] = float("-inf")
    cs[2][:, :2] = float("-inf")
    hole = torch.rand((b, s), generator=gen) < 0.15
    cs[1][hole] = float("-inf")
    odd = (torch.arange(b) % 2 == 1)[:, None]
    cs[2][(torch.rand((b, s), generator=gen) < 0.15) & (odd | ~hole)] = float("-inf")
    log_b[(torch.rand((b, t, s), generator=gen) < 0.03) & odd[..., None]] = float("-inf")
    lengths = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32)
    lengths[0] = t
    if zero_length:
        lengths[1::3] = 0
        lengths[2::5] = 1
    reach = torch.clamp(3 * (lengths - 1) // 2, min=0, max=s - 1)
    drop = (torch.rand((b,), generator=gen) * (reach // 4 + 1).float()).floor()
    fin = reach - drop.to(torch.int32)
    fin[0] = reach[0]
    past = 2 * (lengths - 1) + 1
    off = torch.zeros((b,), dtype=torch.bool)
    off[3::8] = True
    fin = torch.where(off & (lengths >= 1) & (past < s), past, fin).to(torch.int32)
    return tuple(x.to(dev) for x in (log_b, *cs, lengths, fin))


def fb_coverage(lengths, fin, gamma, xi, ll):
    """What an E-step case exercises, checked before its comparison counts:
    -> (share of utterances of length >= 1 with a finite ll, row 0's highest
    state with nonzero gamma, ok). ok: that share >= 0.5 with row 0 among
    them, that state row 0's final, and for each valid utterance every live
    gamma row summing to 1 and the xi sums to length - 1 (a posterior's own
    identities) within 25%: a check of coverage, not of accuracy (that is
    the comparison), since float32 chains of 2T steps at |ll| ~ T drift
    by ~9% at T = 4000."""
    lengths, fin = lengths.long(), fin.long()
    live = lengths >= 1
    valid = torch.isfinite(ll) & live
    share = float(valid.sum()) / max(int(live.sum()), 1)
    rows = torch.arange(gamma.shape[1], device=gamma.device)[None, :] < lengths[:, None]
    sums_ok = bool(((gamma.sum(dim=2) - 1).abs() <= 0.25)[rows & valid[:, None]].all())
    pairs = (lengths - 1).clamp(min=0).to(xi.dtype)
    xi_ok = bool(((xi.sum(dim=(1, 2)) - pairs).abs() <= 0.25 * pairs.clamp(min=1))[valid].all())
    nz = torch.nonzero(gamma[0].amax(dim=0) > 0)
    top = int(nz.max()) if nz.numel() else -1
    ok = share >= 0.5 and bool(valid[0]) and top == int(fin[0]) and sums_ok and xi_ok
    return share, top, ok


def expf_probe(args, fb_out, got_post, want_post):
    """Where the E-step kernel and its plain version differ, which side's
    exp rounds correctly. Each differing cell's exponents are rebuilt from
    FB's alpha/beta mode (bitwise its plain version where this runs) in the
    plain version's order: e = (alpha + beta) - ll for gamma, e =
    ((alpha_t[v - k] + c_k) + (log_b + beta_{t+1})) - ll for each pair of an
    xi sum. A side counts as correctly rounded where its value is exp(e)
    rounded once from float64 (for xi: those terms summed in float32 from
    the last pair down). The plain side is also held to torch.exp(e) on the
    card, to show the exponents are the ones it saw. Subnormal: either side's
    value below the smallest normal float32."""
    alpha, beta, ll = fb_out
    log_b, cs, lengths = args[0], args[1:4], args[4]
    tiny = torch.finfo(torch.float32).tiny
    ll_c = torch.where(torch.isfinite(ll), ll, torch.zeros_like(ll))
    g, w = got_post[0], want_post[0]
    cells = g.view(torch.int32) != w.view(torch.int32)
    e = (alpha + beta - ll_c[:, None, None])[cells]
    rounded = torch.exp(e.double()).float()
    out = {"gamma_cells": int(cells.sum()),
           "gamma_kernel_correctly_rounded": int((g[cells] == rounded).sum()),
           "gamma_plain_correctly_rounded": int((w[cells] == rounded).sum()),
           "gamma_plain_is_torch_exp": int((w[cells] == torch.exp(e)).sum()),
           "gamma_subnormal": int(((g[cells].abs() < tiny) | (w[cells].abs() < tiny)).sum())}
    xg, xw = got_post[1], want_post[1]
    xcells = (xg.view(torch.int32) != xw.view(torch.int32)).nonzero().tolist()
    counts = {"kernel": 0, "plain": 0, "plain_torch": 0, "subnormal": 0}
    for bi, k, v in xcells:
        n = int(lengths[bi])
        if v < k or n < 2:
            continue
        e = ((alpha[bi, : n - 1, v - k] + cs[k][bi, v])
             + (log_b[bi, 1:n, v] + beta[bi, 1:n, v])) - ll_c[bi]
        sums = []
        for terms in (torch.exp(e.double()).float(), torch.exp(e)):
            acc = np.float32(0.0)
            for term in terms.cpu().numpy()[::-1]:
                acc = np.float32(acc + term)
            sums.append(acc)
        counts["kernel"] += int(np.float32(xg[bi, k, v].item()) == sums[0])
        counts["plain"] += int(np.float32(xw[bi, k, v].item()) == sums[0])
        counts["plain_torch"] += int(np.float32(xw[bi, k, v].item()) == sums[1])
        counts["subnormal"] += int(min(abs(xg[bi, k, v].item()), abs(xw[bi, k, v].item())) < tiny)
    out.update({"xi_cells": len(xcells), "xi_kernel_correctly_rounded": counts["kernel"],
                "xi_plain_correctly_rounded": counts["plain"],
                "xi_plain_is_torch_exp_sum": counts["plain_torch"],
                "xi_subnormal": counts["subnormal"]})
    from cs304_tpu_torch.ops.cuda import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    out.update({"nvcc": nvcc.stdout.strip().splitlines()[-1], "torch_cuda": torch.version.cuda})
    return out


def bw_gmm_phases(dev, pipe, launches, timings, errs, yardsticks):
    """Phases 19-21: the Baum-Welch sentence forward-backward kernel (FB),
    embedded Baum-Welch training, and the GMM slice (training, decoding,
    checkpoints, pools) on phase 9's models."""
    import tempfile

    from cs304_tpu_torch.models import train_fused as tf
    from cs304_tpu_torch.models.decoder import ContinuousDecoder
    from cs304_tpu_torch.models.train_continuous import (
        ContinuousTrainConfig,
        ContinuousTrainer,
        insert_silence,
    )
    from cs304_tpu_torch.models.train_continuous_gmm import (
        GMMContinuousTrainConfig,
        GMMContinuousTrainer,
        fused_gmm_iteration,
        promote_to_gmm,
    )
    from cs304_tpu_torch.ops.cuda import emission as em
    from cs304_tpu_torch.ops.cuda import trellis_banded as tb
    from cs304_tpu_torch.ops.cuda import trellis_fb as tfb
    from cs304_tpu_torch.ops.mfcc import mfcc_batch
    from cs304_tpu_torch.ops.streaming_batch import BatchedStreamingComposite
    from cs304_tpu_torch.utils.checkpoint import load_models, save_models

    # -- 19. FB vs plain ------------------------------------------------------
    t_phase = time.perf_counter()
    lb_sent, c0, c1, c2, train_lengths = pipe["k3_args"]
    final = tb.final_states(pipe["n_states"], lb_sent.shape[2])
    fb_err, fb_bitwise = {"fb": 0.0, "post": 0.0}, {"fb": True, "post": True}

    def compare(mode, got, want):
        """The same -inf cells and the same zero cells, finite cells within
        1e-5 * max(1, |x|); bitwise or not is logged, and where not, how
        many cells differ and the largest |x| among them."""
        ok, err, bitwise, differ, largest = True, 0.0, True, 0, 0.0
        for g, w in zip(got, want):
            fin_w = torch.isfinite(w)
            ok &= bool(torch.equal(fin_w, torch.isfinite(g))) and not bool(torch.isnan(g).any())
            ok &= bool(torch.equal(w == 0, g == 0))
            if fin_w.any():
                d = (g[fin_w] - w[fin_w]).abs()
                err = max(err, d.max().item())
                ok &= bool((d <= 1e-5 * w[fin_w].abs().clamp(min=1.0)).all())
            cells = g.view(torch.int32) != w.view(torch.int32)
            if cells.any():
                bitwise = False
                differ += int(cells.sum())
                largest = max(largest, w[cells].abs().max().item())
        fb_err[mode] = max(fb_err[mode], err)
        fb_bitwise[mode] &= bitwise
        return ok, err, bitwise, differ, largest

    def fb_check(name, log_b, c0_, c1_, c2_, lengths, fin):
        """FB (alpha, beta, ll) against banded_fb_plain and the E-step mode
        (gamma, xi, ll) against banded_fb_posteriors_plain, one launch each,
        on a case that reaches its finals (fb_coverage)."""
        args_ = (log_b, c0_, c1_, c2_, lengths, fin)
        n_fb, n_post = tfb.banded_fb.launches, tfb.banded_fb_posteriors.launches
        got = kernel_runs("trellis_fb", tfb.banded_fb, *args_)[0]
        got_post = kernel_runs("trellis_fb_posteriors", tfb.banded_fb_posteriors, *args_)[0]
        torch.cuda.synchronize()
        one_each = (tfb.banded_fb.launches == n_fb + len(KERNEL_POISONS)
                    and tfb.banded_fb_posteriors.launches == n_post + len(KERNEL_POISONS))
        want = plain_run(tfb.banded_fb_plain, *args_)
        want_post = plain_run(tfb.banded_fb_posteriors_plain, *args_)
        torch.cuda.synchronize()
        share, top, covered = fb_coverage(lengths, fin, *got_post)
        ok, err, bitwise, _n, _x = compare("fb", got, want)
        ok_p, err_p, bitwise_p, n_p, x_p = compare("post", got_post, want_post)
        b_k, t_k, s_k = log_b.shape
        log("FB", case=name, B=b_k, T=t_k, S=s_k, ok=ok, bitwise=bitwise, max_abs_err=err,
            e_step_ok=ok_p, e_step_bitwise=bitwise_p, e_step_max_abs_err=err_p,
            e_step_cells_differing=n_p, e_step_largest_differing=x_p,
            one_launch_each=one_each, finite_ll_share=share, row0_top_state=top,
            covered=covered, neg_inf_ll=int((~torch.isfinite(got[2])).sum()),
            length_0_rows=int((lengths == 0).sum()), length_1_rows=int((lengths == 1).sum()))
        if not bitwise_p:
            log("FB-expf", case=name, **expf_probe(args_, got, got_post, want_post))
        # Both modes bitwise their plain versions (ROADMAP W5).
        if not (ok and ok_p and bitwise and bitwise_p and one_each and covered):
            raise SystemExit(f"FB or its E-step mode disagrees with its plain version, or the "
                             f"case does not reach its finals ({name})")

    fb_args = (lb_sent, c0, c1, c2, train_lengths, final)
    fb_check("training-shape", *fb_args)
    for name, (b_k, t_k, s_k, zero) in {
            "random-inf": (256, 160, 59, False), "length-0-and-1-rows": (96, 100, 59, True),
            "B5-T1": (5, 1, 59, False), "98-states": (32, 160, 98, False),
            "503-states": (16, 340, 503, False), "2100-states": (4, 1500, 2100, False),
            "T=4000": (6, 4000, 59, False)}.items():
        fb_check(name, *fb_problem(dev, b_k, t_k, s_k, seed=b_k * 7 + s_k, zero_length=zero))
    b_fb, t_fb, s_fb = lb_sent.shape
    timings["trellis_fb"] = (device_ms(lambda: tfb.banded_fb(*fb_args)),
                             cuda_ms(lambda: tfb.banded_fb_plain(*fb_args), reps=2))
    errs["trellis_fb"] = fb_err["fb"]
    b_ms, b_by = fb_bound(b_fb, t_fb, s_fb, train_lengths)
    yardsticks["trellis_fb"] = (None, b_ms, b_by)
    chain = int(train_lengths.clamp(max=t_fb).max().item()) - 1
    short = train_lengths.clamp(max=41)
    fb_short = device_ms(lambda: tfb.banded_fb(lb_sent, c0, c1, c2, short, final))
    slope = (timings["trellis_fb"][0] - fb_short) / (chain - 40) * 1e3
    log("timing", kernel="trellis_fb", ms=timings["trellis_fb"][0],
        plain_ms=timings["trellis_fb"][1], bound_ms=b_ms, bound_by=b_by,
        eager_ms=cuda_ms(lambda: tfb.banded_fb(*fb_args)), bitwise_all_cases=fb_bitwise["fb"],
        chain_steps=chain, slope_us_per_step=slope, serial_floor_ms=chain * slope / 1e3,
        shape=f"B={b_fb} T={t_fb} S={s_fb}")

    # The E-step: forward then backward in one team, a chain of 2 x chain
    # steps. Finals outside the trellis give ll = -inf, and such an
    # utterance skips its backward: the forward's slope alone.
    timings["trellis_fb_posteriors"] = (
        device_ms(lambda: tfb.banded_fb_posteriors(*fb_args)),
        cuda_ms(lambda: tfb.banded_fb_posteriors_plain(*fb_args), reps=2))
    errs["trellis_fb_posteriors"] = fb_err["post"]
    p_ms, p_by = fb_posteriors_bound(b_fb, t_fb, s_fb, train_lengths)
    yardsticks["trellis_fb_posteriors"] = (None, p_ms, p_by)
    outside = torch.full_like(final, s_fb)

    def post_ms(lengths, fin):
        return device_ms(lambda: tfb.banded_fb_posteriors(lb_sent, c0, c1, c2, lengths, fin))

    e_ms = timings["trellis_fb_posteriors"][0]
    e_short = post_ms(short, final)
    f_long, f_short = post_ms(train_lengths, outside), post_ms(short, outside)
    slope_both = (e_ms - e_short) / (chain - 40) * 1e3
    slope_fwd = (f_long - f_short) / (chain - 40) * 1e3
    log("timing", kernel="trellis_fb_posteriors", ms=e_ms,
        plain_ms=timings["trellis_fb_posteriors"][1], bound_ms=p_ms, bound_by=p_by,
        eager_ms=cuda_ms(lambda: tfb.banded_fb_posteriors(*fb_args)),
        bitwise_all_cases=fb_bitwise["post"], chain_steps=f"2 x {chain}",
        forward_only_ms=f_long, slope_us_per_step_fwd=slope_fwd,
        slope_us_per_step_bwd=slope_both - slope_fwd,
        serial_floor_ms=chain * slope_both / 1e3, shape=f"B={b_fb} T={t_fb} S={s_fb}")
    log("phase", which="19 FB", seconds=f"{time.perf_counter() - t_phase:.2f}")

    # -- 20. Baum-Welch training, the E-step kernel vs the plain E-step -----
    t_phase = time.perf_counter()
    boot, labeled = pipe["boot"], pipe["labeled"]
    cfg = ContinuousTrainConfig(max_iterations=3, silence_bootstrap=False, cov_reg=0.1,
                                on_empty_state="keep", update="baum_welch")
    plain_on_card = {"n": 0}
    plain_fns = {name: getattr(tfb, name)
                 for name in ("banded_fb_plain", "banded_fb_posteriors_plain")}

    def counted(fn):
        def run(log_b, *rest):
            plain_on_card["n"] += int(log_b.is_cuda)
            return fn(log_b, *rest)
        return run

    def count_plain(on):
        for name, fn in plain_fns.items():
            setattr(tfb, name, counted(fn) if on else fn)
            if hasattr(tf, name):
                setattr(tf, name, counted(fn) if on else fn)

    runs = {}
    for backend in ("kernel", "plain"):
        tf._FB_BACKEND = backend
        count_plain(True)
        plain_on_card["n"] = 0
        trainer = ContinuousTrainer(dict(boot), cfg, device=dev)
        tfb.banded_fb.launches = tfb.banded_fb_posteriors.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_it = trainer.train(labeled)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[backend] = (trainer, n_it, tfb.banded_fb_posteriors.launches,
                         tfb.banded_fb.launches, plain_on_card["n"])
        log("bw-train", e_step=backend, iterations=n_it, seconds=f"{seconds:.3f}",
            e_step_launches=tfb.banded_fb_posteriors.launches,
            fb_alpha_beta_launches=tfb.banded_fb.launches,
            plain_on_card=plain_on_card["n"], empty_slots=len(trainer.last_empty_slots))
    count_plain(False)
    tf._FB_BACKEND = "kernel"
    (tr_k, it_k, post_launches, fb_launches, plain_k), (tr_p, it_p, *_rest) = (
        runs["kernel"], runs["plain"])
    close = {}
    for n in ("means_g", "covs_g", "log_a_g"):
        a, b = getattr(tr_k, n), getattr(tr_p, n)
        same_inf = np.array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        close[n] = bool(same_inf and np.allclose(a[fin], b[fin], rtol=1e-4, atol=1e-5))
        log("bw-train", param=n, max_abs_diff=float(np.abs(a[fin] - b[fin]).max()),
            bitwise=bool(np.array_equal(a, b)), close=close[n])
    if not (it_k == it_p and all(close.values())):
        raise SystemExit(f"E-step-kernel-trained and plain-trained parameters differ "
                         f"({close}, iterations {it_k} vs {it_p})")
    if post_launches != it_k or fb_launches or plain_k:
        raise SystemExit(f"Baum-Welch training launched the E-step kernel {post_launches} "
                         f"times in {it_k} iterations, FB's alpha/beta mode {fb_launches} "
                         f"times, and ran a plain forward-backward {plain_k} times on the card")
    launches["trellis_fb_posteriors"] = post_launches
    launches["trellis_fb"] = fb_launches

    # Stages of one iteration (CUDA events, fixed inputs).
    corpus = tf.prepare_fused_corpus(labeled, tr_k.state_counts, tr_k.label_index,
                                     insert_silence, 32, device=dev)
    args, kwargs = tr_k._fused_args(corpus), tr_k._fused_kwargs()
    n_chunks, c, t_total, _ = corpus.batch.shape
    b_all = n_chunks * c
    topo = corpus.topo_id.reshape(-1).long()
    lab_u, loc_u, samew_u = (x[topo] for x in (corpus.lab_tab, corpus.loc_tab,
                                                corpus.samew_tab))
    f = len(tr_k.labels) * tr_k.s_max
    lb_bw = tf._gather_sentence_emissions(args[0], args[1], corpus.lab_tab, corpus.loc_tab,
                                          corpus.batch, corpus.topo_id,
                                          tr_k.s_max).reshape(b_all, t_total, -1)
    diags = tf._sentence_trans_diagonals(args[2], lab_u, loc_u, samew_u,
                                         corpus.cross_tab[topo], "exit_only")
    lens = corpus.lengths.reshape(-1)
    n_states = corpus.n_states_t[topo]
    gam, xi, _ll = tf._training_fb(lb_bw, *diags, lens, n_states)
    pa = tf._bw_pass_a(gam, xi, lab_u, loc_u, samew_u, corpus.batch, tr_k.s_max, f)
    c_glob = pa[1].sum(0) / pa[0].sum()
    oh = torch.nn.functional.one_hot(lab_u.long() * tr_k.s_max + loc_u.long(), f).float()

    def e_stage(backend):
        def run():
            tf._FB_BACKEND = backend
            out = tf._training_fb(lb_bw, *diags, lens, n_states)
            tf._FB_BACKEND = "kernel"
            return out
        return run

    def e_step_peak_bytes(backend):
        """Device memory the E-step allocates beyond its inputs."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = e_stage(backend)()
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base

    def gamma_stats():
        """Pass A's gamma part: the slot bmm, counts and frame sums."""
        gam_f = torch.bmm(gam, oh)
        return gam_f.sum(dim=(0, 1)), gam_f.reshape(-1, f).T @ corpus.batch.reshape(
            -1, corpus.batch.shape[-1])

    stage = {
        "emissions": cuda_ms(lambda: tf._gather_sentence_emissions(
            args[0], args[1], corpus.lab_tab, corpus.loc_tab, corpus.batch,
            corpus.topo_id, tr_k.s_max), reps=5),
        "diagonals": cuda_ms(lambda: tf._sentence_trans_diagonals(
            args[2], lab_u, loc_u, samew_u, corpus.cross_tab[topo], "exit_only"), reps=5),
        "e_step": cuda_ms(e_stage("kernel"), reps=5),
        "e_step_plain": cuda_ms(e_stage("plain"), reps=2),
        "pass_a": cuda_ms(lambda: tf._bw_pass_a(gam, xi, lab_u, loc_u, samew_u, corpus.batch,
                                                tr_k.s_max, f), reps=5),
        "pass_a_gamma": cuda_ms(gamma_stats, reps=5),
        "pass_b": cuda_ms(lambda: tf._bw_pass_b(corpus.batch, pa[3], c_glob), reps=5),
        "iteration": cuda_ms(lambda: tf.fused_bw_iteration(*args, **kwargs), reps=5),
    }
    stage["pass_a_trans"] = stage["pass_a"] - stage["pass_a_gamma"]
    stage["m_step_and_glue"] = stage["iteration"] - (
        stage["emissions"] + stage["diagonals"] + stage["e_step"] + stage["pass_a"]
        + stage["pass_b"])
    # No (B, T, S) alpha or beta on the training path: the kernel's E-step
    # allocates gamma, xi and ll and nothing of gamma's size besides.
    gamma_bytes = 4 * lb_bw.numel()
    peak = {backend: e_step_peak_bytes(backend) for backend in ("kernel", "plain")}
    log("bw-train", e_step_peak_mib_kernel=f"{peak['kernel'] / 2**20:.1f}",
        e_step_peak_mib_plain=f"{peak['plain'] / 2**20:.1f}",
        gamma_mib=f"{gamma_bytes / 2**20:.1f}")
    if peak["kernel"] >= 1.5 * gamma_bytes:
        raise SystemExit(f"the E-step kernel's call allocated {peak['kernel']} bytes, more "
                         f"than gamma ({gamma_bytes}) and its xi and ll")

    def bw_iteration_ms(backend):
        """Best of 3: one iteration, a synchronize and a host copy of the new
        parameters."""
        tf._FB_BACKEND = backend
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = tf.fused_bw_iteration(*args, **kwargs)
            torch.cuda.synchronize()
            [o.cpu() for o in out[:3]]
            best = min(best, time.perf_counter() - t0)
        tf._FB_BACKEND = "kernel"
        return best * 1e3

    bw_iteration_ms("kernel")
    it_ms = {}
    for backend in ("plain", "kernel", "kernel", "plain"):
        it_ms[backend] = min(it_ms.get(backend, float("inf")), bw_iteration_ms(backend))
    log("timing", what="Baum-Welch iteration, host wall best of 3 with readback",
        ms_e_step_kernel=it_ms["kernel"], ms_plain_e_step=it_ms["plain"],
        utt_per_s=corpus.num_utts / it_ms["kernel"] * 1e3,
        shape=f"B={b_all} T={t_total} S_sent={lb_bw.shape[2]}")
    log("timing", what="Baum-Welch stages (CUDA events)",
        **{k: f"{v:.4f}" for k, v in stage.items()})
    log("phase", which="20 Baum-Welch", seconds=f"{time.perf_counter() - t_phase:.2f}")

    # -- 21. GMM on phase 9's models -----------------------------------------
    t_phase = time.perf_counter()
    models, pipe_labeled = pipe["models"], pipe["pipe_labeled"]
    truths, eval_feats = pipe["eval"]["train_speakers"]

    def accuracy(dec):
        preds = dec.predict_batch(eval_feats)
        return float(np.mean([p == t for p, t in zip(preds, truths)])), preds

    bw_trainer = ContinuousTrainer(dict(models), ContinuousTrainConfig(
        max_iterations=3, cov_reg=0.1, silence_bootstrap=False, update="baum_welch"),
        device=dev)
    bw_it = bw_trainer.train(pipe_labeled)
    bw_acc, _ = accuracy(ContinuousDecoder(bw_trainer.models(), penalty=-100.0, device=dev))
    log("gmm", what="Baum-Welch refinement of the phase-9 models", iterations=bw_it,
        exact_seq_acc=bw_acc)
    if bw_acc < ACC_BAR:
        raise SystemExit(f"Baum-Welch exact-sequence accuracy {bw_acc} < {ACC_BAR}")

    gmm0 = promote_to_gmm(models, 2)
    gcfg = GMMContinuousTrainConfig(max_iterations=4, cov_reg=0.1)
    gruns = {}
    for backend in ("scanfree", "scan"):
        tf._TRELLIS_BACKEND = backend
        tb.banded_decode.launches = 0
        trainer = GMMContinuousTrainer(dict(gmm0), gcfg, device=dev)
        t0 = time.perf_counter()
        n_it = trainer.train(pipe_labeled)
        torch.cuda.synchronize()
        gruns[backend] = (trainer, n_it, tb.banded_decode.launches)
        log("gmm", trellis=backend, iterations=n_it, seconds=f"{time.perf_counter() - t0:.3f}",
            k3_launches=tb.banded_decode.launches)
    tf._TRELLIS_BACKEND = "scanfree"
    (g_k, n_k, k3_l), (g_p, n_p, k3_p) = gruns["scanfree"], gruns["scan"]
    same = {n: bool(np.array_equal(getattr(g_k, n), getattr(g_p, n)))
            for n in ("means_g", "covs_g", "weights_g", "log_a_g")}
    log("gmm", iterations_equal=n_k == n_p, params_bitwise=json.dumps(same),
        finite=bool(np.isfinite(g_k.means_g).all() and np.isfinite(g_k.covs_g).all()))
    if not (n_k == n_p and all(same.values())) or k3_l == 0 or k3_p:
        raise SystemExit(f"GMM training: K3 and plain runs differ or K3 did not launch "
                         f"({same}, launches {k3_l}/{k3_p})")
    gfused = tf.prepare_fused_corpus(pipe_labeled, g_k.state_counts, g_k.label_index,
                                     insert_silence, 32, chunk_utts=32, device=dev)
    g_args, g_kwargs = g_k._args(gfused), g_k._kwargs()

    def gmm_iteration_ms():
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fused_gmm_iteration(*g_args, **g_kwargs)
            torch.cuda.synchronize()
            [o.cpu() for o in out[:4]]
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    gmm_iteration_ms()
    log("timing", what="GMM iteration (K=2), host wall best of 3 with readback",
        ms=gmm_iteration_ms(), utt_per_s=gfused.num_utts / gmm_iteration_ms() * 1e3,
        shape=f"B={gfused.batch.shape[0] * gfused.batch.shape[1]} "
              f"T={gfused.batch.shape[2]} utterances={gfused.num_utts}")

    gmm = g_k.models()
    dec_w = ContinuousDecoder(gmm, penalty=-100.0, device=dev)
    acc_w, preds_w = accuracy(dec_w)
    s_states = dec_w.composite.num_states
    tiers = {}
    for tier in ("highest", "high", "default"):
        dec_q = ContinuousDecoder(gmm, penalty=-100.0, emissions="quad",
                                  emission_precision=tier, device=dev)
        em.emission.launches = em.emission_split.launches = 0
        acc_q, preds_q = accuracy(dec_q)
        torch.cuda.synchronize()
        kernel = em.emission if tier == "highest" else em.emission_split
        tiers[tier] = (acc_q, float(np.mean([a == b for a, b in zip(preds_q, preds_w)])),
                       kernel.launches)
        log("gmm", decoder="quad", tier=tier, gaussians=dec_q._n_gauss, s_pad=dec_q._s_pad,
            launches=kernel.launches, exact_seq_acc=acc_q, agreement_with_whiten=tiers[tier][1])
        if kernel.launches == 0 or dec_q._n_gauss != 2 * s_states:
            raise SystemExit(f"GMM quad at {tier} did not run its kernel over S*K columns")
    corpus_a = pipe["corpus"]
    clips = [corpus_a.sentence_audio(tr, spk, jitter_seed=33)
             for tr in PIPELINE_TRANSCRIPTS for spk in range(6)]
    texts_sig = dec_w.predict_signal_batch(clips)
    texts_feat = dec_w.predict_batch(mfcc_batch(clips, device=dev))
    with tempfile.TemporaryDirectory() as folder:
        save_models(gmm, folder)
        loaded = load_models(folder)
        _, preds_l = accuracy(ContinuousDecoder(loaded, penalty=-100.0, device=dev))
    log("gmm", decoder="whiten", exact_seq_acc=acc_w, signal_equals_features=texts_sig == texts_feat,
        checkpoint_texts_equal=preds_l == preds_w, states=s_states)
    if acc_w < ACC_BAR or texts_sig != texts_feat or preds_l != preds_w:
        raise SystemExit(f"GMM decoding failed its gates (accuracy {acc_w}, signal == "
                         f"features {texts_sig == texts_feat}, checkpoint {preds_l == preds_w})")

    utts = eval_feats[:12]

    def pool_texts(device, step_impl):
        pool = BatchedStreamingComposite.from_models(
            gmm, penalty=-100.0, num_slots=16, chunk_size=16, max_frames=512,
            step_impl=step_impl, device=device)
        slots = [pool.start() for _ in utts]
        for lo in range(0, max(len(u) for u in utts), 16):
            pool.step({s: u[lo: lo + 16] for s, u in zip(slots, utts) if lo < len(u)})
        out = pool.finalize(slots)
        return pool.step_impl, [out[s][1] for s in slots]

    for step_impl in ("auto", "banded"):
        impl, on_card = pool_texts(dev, step_impl)
        _, on_cpu = pool_texts("cpu", step_impl)
        log("gmm", pool=impl, states=s_states, texts_equal_cpu=on_card == on_cpu,
            agreement_with_offline=float(np.mean([a == b for a, b in zip(on_card, preds_w)])))
        if on_card != on_cpu:
            raise SystemExit(f"the GMM pool ({impl}) on the card differs from the CPU pool")
    log("phase", which="21 GMM", seconds=f"{time.perf_counter() - t_phase:.2f}")


def record_log_z(pool, into):
    """Make a confidence pool's decoder note each final's log Z: into maps
    (text, confidence) -> log Z, the confidence being the final's (its
    words' least), read from the sum passes of the same call."""
    from cs304_tpu_torch.ops import lattice

    dec = pool._decoder
    scored_with = dec.predict_batch_with_confidence

    def wrapped(features, *args, **kwargs):
        seen = []
        passes = lattice._sum_passes

        def noting(*a, **k):
            out = passes(*a, **k)
            seen.append(out[3].cpu().numpy())
            return out

        lattice._sum_passes = noting
        try:
            scored = scored_with(features, *args, **kwargs)
        finally:
            lattice._sum_passes = passes
        for words, log_z in zip(scored, np.concatenate(seen)):
            text = "".join(w for w, _s, _e, _c in words)
            conf = min((c for _w, _s, _e, c in words), default=0.0)
            prev = into.get((text, conf))
            into[(text, conf)] = float(log_z) if prev is None else min(prev, float(log_z),
                                                                       key=abs)
        return scored

    dec.predict_batch_with_confidence = wrapped


def search_decode_bound(b, t, s, lengths, n_words=0, beam=False):
    """bound() of one search decode: the live log_b rows in, paths and
    scores out, coefficients, lengths and the LM's tables (pair, word_of,
    uppers); per step these lengths run, 6 operations a state (the banded
    candidates), 2 a (source, target) word pair with the LM (an add and a
    compare), 2 a state with the beam (its max and the prune), at
    PEAK_FP32_ALU."""
    live = int(lengths.clamp(min=1, max=t).sum().item())
    lm_bytes = 4 * (n_words * n_words + s + n_words) if n_words else 0
    ops = (live - b) * (6 * s + 2 * n_words * n_words + (2 * s if beam else 0))
    return bound(4 * live * s + 4 * b * t + 8 * b + 32 * s + lm_bytes,
                 [(ops, PEAK_FP32_ALU)])


def stream_lm_bound(rows, valid, s, ring_bytes, n_words):
    """stream_bound() with the LM's tables read and 2 operations a
    (source, target) word pair a frame."""
    frames = rows * valid
    return bound(4 * frames * s + 8 * rows * s + ring_bytes * frames * s + 32 * s + 12 * rows
                 + 4 * (n_words * n_words + s + n_words),
                 [(frames * (6 * s + 2 * n_words * n_words), PEAK_FP32_ALU)])


def search_phase(dev, decode, pipe, launches, timings, errs, yardsticks):
    """Phase 22: search on the decoder. The LM and BEAM decode modes and the
    LM stream mode against their plain versions; bigram and beam decoders
    on the 512 clips; n-best, confidences and constrained decodes on phase
    9's models; bigram and confidence serving."""
    from cs304_tpu_torch.models import decoder as dm
    from cs304_tpu_torch.models.hmm import flagship_models
    from cs304_tpu_torch.ops import grammar as gm
    from cs304_tpu_torch.ops import lattice as tla
    from cs304_tpu_torch.ops import streaming_batch as sb
    from cs304_tpu_torch.ops import viterbi_counted as tvc
    from cs304_tpu_torch.ops import viterbi_duration as tvd
    from cs304_tpu_torch.ops.cuda import trellis_constrained as tcs
    from cs304_tpu_torch.ops.cuda import trellis_dense as tdn
    from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.cuda import trellis_stream as tst
    from cs304_tpu_torch.ops.grammar import WordDFA
    from cs304_tpu_torch.ops.lm import train_word_bigram, word_pair_penalties
    from cs304_tpu_torch.ops.viterbi import (
        forward_fast,
        lm_tables,
        pack_coefs,
        viterbi_composite_batch_fast,
    )
    from cs304_tpu_torch.serving import ServingSessionPool

    t_phase = time.perf_counter()
    flag, lb3, n_frames = decode["comp"], decode["lb3"], decode["n_frames"]
    b, t_total, _ld = lb3.shape
    gen = torch.Generator(device=dev).manual_seed(22)
    rng = np.random.default_rng(22)

    def digit_bigram(comp):
        """A bigram trained on 500 seeded random word strings."""
        words = [lab for lab in comp.labels if lab != "S"]
        corpus = [tuple(rng.choice(words, size=int(rng.integers(1, 8)))) for _ in range(500)]
        return train_word_bigram(corpus, comp.labels)

    def pair_of(comp, mode="trained"):
        pair = word_pair_penalties(comp, digit_bigram(comp), 1.0)
        if mode == "ties":
            pair[:] = np.float32(-7.0)
        elif mode == "zero":
            pair[:, :2] = 0.0
            pair[1] = 0.0
        return pair

    err = {"trellis_decode_lm": 0.0, "trellis_decode_beam": 0.0, "trellis_stream_lm": 0.0}

    # -- (a) the three variants against their plain versions ----------------
    def search_check(name, comp, log_b, lengths, pair=None, beam=None, codes=None,
                     table=None):
        s_k = comp.num_states
        topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
        coefs = pack_coefs(*topo, device=dev)
        lm = lm_tables(pair, comp.word_of_state, comp.uppers, device=dev) if pair is not None \
            else None
        key = "trellis_decode_lm" if lm is not None else "trellis_decode_beam"
        if lm is not None:
            got = kernel_runs(key, tsf.scanfree_decode_lm, log_b, coefs, lm, lengths,
                              beam=beam)[0]
        else:
            got = kernel_runs(key, tsf.scanfree_decode_beam, log_b, coefs, comp.penalty,
                              lengths, beam)[0]
        want = plain_run(
            viterbi_composite_batch_fast, log_b[..., :s_k].contiguous(), *topo, comp.penalty,
            lengths, pair_penalty=pair, word_of_state=comp.word_of_state, uppers=comp.uppers,
            beam=beam)
        torch.cuda.synchronize()
        same = {"scores": torch.equal(got[0], want[0]), "paths": torch.equal(got[1], want[1]),
                "score_signs": torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))}
        finite = torch.isfinite(want[0])
        both = finite & torch.isfinite(got[0])
        e = (got[0] - want[0])[both].abs().max().item() if both.any() else 0.0
        err[key] = max(err[key], e)
        b_k, t_k = log_b.shape[:2]
        w = len(comp.labels) if lm is not None else 0
        took = "shared" if tsf.codes_scratch_bytes(b_k, t_k, s_k, w) == 0 else "global"
        # The LM's pair table: columns in registers (S <= 64, W <= 32),
        # staged in shared memory after the codes, or read from global memory.
        tab = tsf.lm_table_branch(t_k, s_k, w) if w else None
        pruned = None
        if beam is not None:
            alpha = forward_fast(log_b, coefs, comp.penalty, lengths, lm=lm, beam=beam)[0]
            pruned = (~torch.isfinite(alpha)).float().mean().item()
        log("search", case=name, mode=key.split("_")[-1] + ("+beam" if lm and beam else ""),
            B=b_k, T=t_k, S=s_k, W=w or None, beam=beam, codes=took, table=tab,
            equal=json.dumps(same), finite_rows=finite.float().mean().item(),
            final_states_pruned=pruned, max_abs_err=e)
        if not all(same.values()) or finite.float().mean().item() < 0.5:
            raise SystemExit(f"phase 22: {key} disagrees with its plain version ({name}), or "
                             f"its case compares -inf")
        if codes is not None and took != codes:
            raise SystemExit(f"phase 22: case {name} kept its codes in {took} memory, not {codes}")
        if w and tab != table:
            raise SystemExit(f"phase 22: case {name} read its pair table from {tab} memory, "
                             f"not {table}")

    def rand_lengths(nb, t):
        ln = torch.randint(1, t + 1, (nb,), generator=gen, device=dev, dtype=torch.int32)
        ln[0] = t
        return ln

    c503, c5003 = random_composite(100, 3), random_composite(1000, 3)
    s58 = flag.num_states
    search_check("flagship-lm", flag, lb3, n_frames, pair_of(flag), codes="shared",
                 table="registers")
    lbi = torch.randint(-3, 1, (64, t_total, s58), generator=gen, device=dev).float()
    search_check("flagship-lm-ties", flag, lbi, rand_lengths(64, t_total), pair_of(flag, "ties"),
                 table="registers")
    search_check("flagship-lm-zero", flag, 3 * torch.randn((64, t_total, s58), generator=gen,
                                                            device=dev),
                 rand_lengths(64, t_total), pair_of(flag, "zero"), table="registers")
    lb503 = 3 * torch.randn((64, t_total, c503.num_states), generator=gen, device=dev)
    len503 = rand_lengths(64, t_total)
    pair503 = pair_of(c503)
    search_check("503-lm", c503, lb503, len503, pair503, table="shared")
    lb5003 = 3 * torch.randn((4, 60, c5003.num_states), generator=gen, device=dev)
    len5003 = rand_lengths(4, 60)
    pair5003 = pair_of(c5003)
    search_check("5003-lm", c5003, lb5003, len5003, pair5003, codes="global", table="global")
    search_check("flagship-beam-50", flag, lb3, n_frames, beam=50.0)
    lb_rand = 3 * torch.randn((b, t_total, s58), generator=gen, device=dev)
    len_rand = rand_lengths(b, t_total)
    search_check("flagship-beam-5", flag, lb_rand, len_rand, beam=5.0)
    search_check("flagship-lm+beam-50", flag, lb3, n_frames, pair_of(flag), beam=50.0,
                 table="registers")
    search_check("503-beam-10", c503, lb503, len503, beam=10.0)

    def stream_lm_check(name, comp, slots, t_max, ring_dtype, table, n_steps=6, chunk=16):
        s_k = comp.num_states
        tab = tsf.lm_table_branch(chunk, s_k, len(comp.labels), decode=False)
        coefs = pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                           device=dev)
        lm = lm_tables(pair_of(comp), comp.word_of_state, comp.uppers, device=dev)
        lm_p, coefs_p = tuple(x.cpu() for x in lm), coefs.cpu()
        alpha = torch.full((slots, s_k), float("-inf"), device=dev)
        ring = torch.full((slots, t_max, s_k), -1, dtype=ring_dtype, device=dev)
        alpha_p, ring_p = alpha.cpu(), ring.cpu()
        srng = np.random.default_rng(s_k + slots)
        same = {"alpha": True, "alpha_sign": True, "ring": True}
        for slot_ids, t, valid in stream_steps(srng, slots, chunk, t_max, n_steps, False):
            lb = torch.as_tensor((3 * srng.normal(size=(slots, chunk, s_k))).astype(np.float32))
            rows = [torch.as_tensor(x, device=dev) for x in (slot_ids, t, valid)]
            alpha, ring = stream_step_runs(
                "trellis_stream_lm", lambda a, r: tst.stream_advance_lm(
                    a, r, *rows, lb.to(dev), coefs, lm),
                alpha, ring, slot_ids, t, valid)
            poison_rows(ring_p, slot_ids, t, valid, PLAIN_POISON)
            sb._advance_compact(alpha_p, ring_p, slot_ids, t, valid, lb, coefs_p[6],
                                coefs_p[4] > 0, coeffs=sb._coeffs_of(coefs_p, 0.0, lm_p))
            torch.cuda.synchronize()
            got_a = alpha.cpu()
            same["alpha"] &= torch.equal(got_a, alpha_p)
            same["alpha_sign"] &= torch.equal(torch.signbit(got_a), torch.signbit(alpha_p))
            same["ring"] &= torch.equal(ring.cpu(), ring_p)
        live = torch.isfinite(alpha_p).any(dim=1).float().mean().item()
        log("search", case=name, mode="stream_lm", slots=slots, S=s_k, W=len(comp.labels),
            ring=str(ring_dtype).split(".")[-1], steps=n_steps, table=tab,
            equal=json.dumps(same), live_slots=live)
        # The stream mode never stages the table (a 16-frame launch does not
        # repay it): the register columns at W <= 32, else the cache.
        if not all(same.values()) or live < 0.5 or tab != table:
            raise SystemExit(f"phase 22: the LM stream mode disagrees with its plain version "
                             f"({name}), or read its pair table from {tab}, not {table}")

    stream_lm_check("flagship-512-slots", flag, 512, 128, torch.int8, "registers")
    stream_lm_check("503-256-slots", c503, 256, 128, torch.int32, "global", n_steps=4)

    # -- (b) bigram and beam decoders on the 512 clips ------------------------
    signals, sig_dev, ns_dev = decode["signals"], decode["sig_dev"], decode["ns_dev"]
    bigram = digit_bigram(flag)
    plain_on_card = {}

    counters = {"trellis_decode_lm": tsf.scanfree_decode_lm,
                "trellis_decode_beam": tsf.scanfree_decode_beam,
                "trellis_decode": tsf.scanfree_decode}
    beam_main = 50.0
    searches = {"bigram": {"bigram": bigram}, "beam": {"beam": beam_main}}
    e2e = {}
    for what, kw in searches.items():
        cpu_texts = dm.ContinuousDecoder(flagship_models(), penalty=-100.0, device="cpu",
                                         **kw).predict_signal_batch(list(signals))
        dec = dm.ContinuousDecoder(flagship_models(), penalty=-100.0, device="cuda", **kw)
        saved = [guard(plain_on_card, dm, "viterbi_composite_batch_fast"),
                 guard(plain_on_card, tsf, "_plain_search"),
                 guard(plain_on_card, tsf, "forward_fast")]
        try:
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            texts = dec.predict_signal_batch(list(signals))
            torch.cuda.synchronize()
            got_launches = {n: c.launches for n, c in counters.items()}
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        key = "trellis_decode_lm" if what == "bigram" else "trellis_decode_beam"
        launches[key] = got_launches[key]
        log("search", decoder=what, B=len(texts), transcripts_equal_cpu=texts == cpu_texts,
            launches=json.dumps(got_launches), plain_on_card=json.dumps(plain_on_card),
            distinct_transcripts=len(set(texts)))
        if texts != cpu_texts or got_launches[key] == 0 or plain_on_card:
            raise SystemExit(f"phase 22: the {what} decoder on the card is not the CPU port's, "
                             f"never launched its mode, or ran the plain trellis")
    # ms a batch of decode_signals, flat / bigram / beam, with the whitening
    # emissions (the decoders above) and with phase 5's quad emissions, in
    # turns (forward, then backward), best of the two windows each.
    decoders = {}
    for emissions in ("whiten", "quad"):
        for what, kw in (("flat", {}), *searches.items()):
            decoders[f"{what}-{emissions}"] = dm.ContinuousDecoder(
                flagship_models(), penalty=-100.0, emissions=emissions, device="cuda", **kw)
    for d in decoders.values():
        d.decode_signals(sig_dev, ns_dev)
    for name in (*decoders, *reversed(decoders)):
        e2e[name] = min(e2e.get(name, float("inf")),
                        window(lambda: decoders[name].decode_signals(sig_dev, ns_dev)))
    log("timing", what="decode_signals ms a batch, B=512 clips of 1.5 s, best of 3 windows",
        **e2e)

    # -- (c) phase 9's trained models -------------------------------------------
    models = pipe["models"]
    labels = sorted(models)
    lm_pipe = train_word_bigram(PIPELINE_TRANSCRIPTS, labels, insert_silence=True)
    lm_dec = dm.ContinuousDecoder(models, penalty=-100.0, bigram=lm_pipe, device="cuda")
    flat_dec = dm.ContinuousDecoder(models, penalty=-100.0, device="cuda")
    acc = {}
    for split, (truths, feats) in pipe["eval"].items():
        preds = lm_dec.predict_batch(feats)
        acc[split] = float(np.mean([p == t for p, t in zip(preds, truths)]))
    log("search", what="bigram decode of phase 9's models", exact_seq_acc=json.dumps(acc))
    if acc["train_speakers"] < ACC_BAR:
        raise SystemExit(f"phase 22: bigram exact-sequence accuracy {acc} < {ACC_BAR}")
    truths = pipe["eval"]["train_speakers"][0] + pipe["eval"]["unseen_speakers"][0]
    feats = pipe["eval"]["train_speakers"][1] + pipe["eval"]["unseen_speakers"][1]
    clips, clip_truths = (feats * 2)[:64], (truths * 2)[:64]
    kernel_counters = {"dense": tdn.trellis_dense_forward, "backtrace": tsf.trellis_backtrace,
                       "decode": tsf.scanfree_decode, "planes": tcs.planes_decode,
                       "duration": tcs.duration_decode, "lsum": tlk.lattice_sum_passes,
                       "lmax": tlk.lattice_max_passes, "kbest": tlk.kbest_forward}
    grammar = WordDFA.from_strings(PIPELINE_TRANSCRIPTS, labels)
    by_count = {}
    for i, tr in enumerate(clip_truths):
        by_count.setdefault(len(tr), []).append(i)

    def counted_all(dec):
        out = [""] * len(clips)
        for n, idx in by_count.items():
            for i, text in zip(idx, dec.predict_batch_counted([clips[i] for i in idx], n)):
                out[i] = text
        return out

    # The kernels walk their codes: no K2-bt launch (checked below).
    constrained = {
        "counted (64 clips, true counts)": (counted_all, ["planes"]),
        "duration (64 clips, min 2)": (lambda d: d.predict_batch_duration(clips, 2),
                                       ["duration"]),
        "grammar (64 clips, 6-string menu)": (lambda d: d.predict_batch_grammar(clips, grammar),
                                              ["planes"]),
    }
    # The posterior and n-best searches on their kernels (phase 31 holds
    # them against their plain versions).
    searches = {
        "confidences (64 clips)": (lambda: flat_dec.predict_batch_with_confidence(clips),
                                   ["dense", "backtrace", "lsum"]),
        "nbest (1 clip, n=4)": (lambda: flat_dec.predict_nbest(clips[0], n=4), ["kbest"]),
        "forward lattice + posteriors (1 clip)": (
            lambda: tla.forward_lattice(flat_dec.composite, clips[0], posteriors=True,
                                        device=dev), ["lmax", "lsum"]),
    }
    runs = {
        **{what: f for what, (f, _need) in searches.items()},
        **{what: (lambda f=f: f(flat_dec)) for what, (f, _need) in constrained.items()},
    }
    # The constrained decodes' transcripts on the CPU (plain trellises).
    cpu_dec = dm.ContinuousDecoder(models, penalty=-100.0, device="cpu")
    cpu_texts = {what: f(cpu_dec) for what, (f, _need) in constrained.items()}
    constrained_plain = {}
    saved = [guard(constrained_plain, m, n) for m, n in (
        (tvc, "viterbi_composite_counted_batch_plain"),
        (gm, "viterbi_composite_grammar_batch_plain"),
        (tvd, "viterbi_composite_duration_batch_plain"),
        (tlk, "lattice_sum_passes_plain"), (tlk, "lattice_max_passes_plain"),
        (tlk, "kbest_forward_plain"))]
    search_ms, run_launches = {}, {}
    try:
        for what, fn in runs.items():
            fn()
            best, out = float("inf"), None
            for _ in range(2):
                for c in kernel_counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                best = min(best, (time.perf_counter() - t0) * 1e3)
                run_launches[what] = {n: c.launches for n, c in kernel_counters.items()}
            search_ms[what] = best
            if what.startswith("nbest"):
                acc_x = float(out[0][1] == clip_truths[0])
            elif what.startswith("forward lattice"):
                acc_x = float(out.contains(clip_truths[0]))
            else:
                texts = (["".join(w for w, *_r in u) for u in out] if what.startswith("conf")
                         else out)
                acc_x = float(np.mean([p == t for p, t in zip(texts, clip_truths)]))
            extra = {}
            if what in searches:
                check_launches(f"phase 22: {what}", run_launches[what], searches[what][1])
            if what in constrained:
                extra["transcripts_equal_cpu"] = out == cpu_texts[what]
                if not extra["transcripts_equal_cpu"]:
                    raise SystemExit(f"phase 22: the {what} decode on the card differs from "
                                     f"the CPU decoder's")
                check_launches(f"phase 22: {what}", run_launches[what], constrained[what][1])
                if run_launches[what]["backtrace"]:
                    raise SystemExit(f"phase 22: {what} launched K2-bt, where its kernel walks "
                                     f"its codes: {run_launches[what]}")
            log("search", run=what, ms=best, exact_seq_acc=acc_x,
                launches=json.dumps(run_launches[what]), **extra)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    if constrained_plain:
        raise SystemExit(f"phase 22: a plain constrained, posterior or n-best search ran on "
                         f"the card: {constrained_plain}")
    launches["trellis_planes"] = sum(run_launches[w]["planes"] for w in constrained)
    launches["trellis_duration"] = sum(run_launches[w]["duration"] for w in constrained)
    launches["lattice_sum"] = run_launches["confidences (64 clips)"]["lsum"]
    launches["lattice_max"] = run_launches["forward lattice + posteriors (1 clip)"]["lmax"]
    launches["kbest"] = run_launches["nbest (1 clip, n=4)"]["kbest"]
    constrained_split(dev, flat_dec, clips, by_count, grammar, search_ms)
    search_split(dev, flat_dec, clips, search_ms)

    # -- (d) phase 18's traffic under bigram and confidence serving -----------
    audio, warm = serving_traffic(pipe["corpus"])
    lm_serve = train_word_bigram(PIPELINE_TRANSCRIPTS, labels, insert_silence=True)
    which_card = range(min(16, len(audio)))
    for what, kw in (("bigram", {"bigram": lm_serve}), ("confidences", {"confidences": True})):
        # Every card session's confidences are held against the CPU pool's
        # (the gate's sample); the bigram pool's first 4.
        which_cpu = which_card if what == "confidences" else range(4)
        pool = ServingSessionPool(models, num_slots=64, max_frames=4096, device="cuda", **kw)
        cpu = ServingSessionPool(models, num_slots=64, max_frames=4096, device="cpu", **kw)
        log_z_of = {id(pool): {}, id(cpu): {}}
        if what == "confidences":
            for p_x in (pool, cpu):
                record_log_z(p_x, log_z_of[id(p_x)])
        tst.stream_advance_lm.launches = 0
        results, _polls, wall, round_ms = drive_sessions(pool, which_card, audio, warm)
        stream_lm = tst.stream_advance_lm.launches
        if what == "bigram":
            launches["trellis_stream_lm"] = stream_lm
        results_c, _pc, _w, _r = drive_sessions(cpu, which_cpu, audio, warm)
        card = [[(r.text, r.num_samples) for r in rs] for rs in results[:len(which_cpu)]]
        host = [[(r.text, r.num_samples) for r in rs] for rs in results_c]
        # A confidence is exp(lambda), lambda = alpha + penalty + beta -
        # log Z: a difference of float32 sums of magnitude |log Z|, each
        # device rounding its own sums (and scoring its own emissions). The
        # gate: within 1e-4, or log-confidences within CONF_ULPS float32
        # ulps of that final's |log Z| (the larger of the two devices'),
        # capped at the 4e-3 the gate allowed before |log Z| was measured.
        conf_ok, conf_rows = True, []
        for ra, rc in zip(results, results_c):
            for a, c in zip(ra, rc):
                if a.confidence is None:
                    continue
                lz = max(abs(log_z_of[id(pool)][(a.text, a.confidence)]),
                         abs(log_z_of[id(cpu)][(c.text, c.confidence)]))
                ulp = float(np.spacing(np.float32(lz)))
                limit = min(CONF_ULPS * ulp, CONF_LOG_CAP)
                d_abs = abs(a.confidence - c.confidence)
                d_log = (abs(np.log(a.confidence) - np.log(c.confidence))
                         if a.confidence > 0 and c.confidence > 0 else float("inf"))
                conf_rows.append((lz, d_abs, d_log, d_log / ulp))
                conf_ok &= d_abs <= 1e-4 or d_log <= limit
        for lz, d_abs, d_log, ratio in conf_rows:
            log("search", confidence_final=what, abs_log_z=lz, ulp=float(np.spacing(np.float32(lz))),
                diff=d_abs, log_diff=d_log, log_diff_ulps=ratio)
        n_finals = sum(len(rs) for rs in results)
        log("search", serving=what, sessions=len(which_card), finals=n_finals,
            finals_equal_cpu=card == host, confidences_compared=len(conf_rows),
            max_confidence_diff=max((r[1] for r in conf_rows), default=0.0),
            max_log_confidence_diff=max((r[2] for r in conf_rows), default=0.0),
            worst_log_diff_ulps=max((r[3] for r in conf_rows), default=0.0),
            gate_ulps=CONF_ULPS, stream_lm_launches=stream_lm, ms_per_feed_round=round_ms,
            wall_s=wall)
        if card != host or not conf_ok or n_finals < len(which_card):
            raise SystemExit(f"phase 22: {what} serving on the card differs from the CPU pool")
        if what == "bigram" and stream_lm == 0:
            raise SystemExit("phase 22: the bigram pool never launched the LM stream mode")

    # -- timing rows --------------------------------------------------------------
    coefs58 = pack_coefs(flag.log_a, flag.lower_of_state, flag.is_entry, flag.is_exit,
                         device=dev)
    lm58 = lm_tables(pair_of(flag), flag.word_of_state, flag.uppers, device=dev)
    coefs503 = pack_coefs(c503.log_a, c503.lower_of_state, c503.is_entry, c503.is_exit,
                          device=dev)
    lm503 = lm_tables(pair503, c503.word_of_state, c503.uppers, device=dev)
    w58, w503 = len(flag.labels), len(c503.labels)
    pen = flag.penalty

    def plain_decode(lb, coefs, lengths, lm=None, beam=None):
        return tsf._plain_search(lb, coefs, pen, lengths, True, lm=lm, beam=beam)

    timings["trellis_decode_lm"] = (
        device_ms(lambda: tsf.scanfree_decode_lm(lb3, coefs58, lm58, n_frames)),
        cuda_ms(lambda: plain_decode(lb3, coefs58, n_frames, lm=lm58), reps=3))
    t503 = (device_ms(lambda: tsf.scanfree_decode_lm(lb503, coefs503, lm503, len503)),
            cuda_ms(lambda: plain_decode(lb503, coefs503, len503, lm=lm503), reps=3))
    timings["trellis_decode_beam"] = (
        device_ms(lambda: tsf.scanfree_decode_beam(lb3, coefs58, pen, n_frames, beam_main)),
        cuda_ms(lambda: plain_decode(lb3, coefs58, n_frames, beam=beam_main), reps=3))
    flat_ms = device_ms(lambda: tsf.scanfree_decode(lb3, coefs58, pen, n_frames))
    yardsticks["trellis_decode_lm"] = (None, *search_decode_bound(b, t_total, s58, n_frames,
                                                                  w58))
    yardsticks["trellis_decode_beam"] = (None, *search_decode_bound(b, t_total, s58, n_frames,
                                                                    beam=True))
    b503 = search_decode_bound(64, t_total, c503.num_states, len503, w503)

    def stream_args(comp, slots, lm):
        s_k = comp.num_states
        alpha = torch.randn((slots, s_k), generator=gen, device=dev)
        ring = torch.zeros((slots, 64, s_k), dtype=sb.ring_dtype(s_k), device=dev)
        ids = torch.arange(slots, dtype=torch.int32, device=dev)
        t = torch.full((slots,), 16, dtype=torch.int32, device=dev)
        valid = torch.full((slots,), 16, dtype=torch.int32, device=dev)
        lb = 3 * torch.randn((slots, 16, s_k), generator=gen, device=dev)
        coefs = pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                           device=dev)
        return alpha, ring, ids, t, valid, lb, coefs, lm

    st58 = stream_args(flag, 512, lm58)
    st503 = stream_args(c503, 256, lm503)
    timings["trellis_stream_lm"] = (
        device_ms(lambda: tst.stream_advance_lm(*st58)),
        cuda_ms(lambda: tst._plain_step(*st58[:7], 0.0, lm58), reps=3))
    flat_stream_ms = device_ms(lambda: tst.stream_advance(*st58[:7], pen))
    s503_ms = device_ms(lambda: tst.stream_advance_lm(*st503))
    yardsticks["trellis_stream_lm"] = (None, *stream_lm_bound(512, 16, s58, 1, w58))
    s503_bound = stream_lm_bound(256, 16, c503.num_states, 4, w503)
    for name in ("trellis_decode_lm", "trellis_decode_beam", "trellis_stream_lm"):
        ms, plain_ms = timings[name]
        lib_ms, b_ms, b_by = yardsticks[name]
        log("timing", kernel=name, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by, launches=launches[name])
    # Every LM shape beside the flat mode at the same inputs (its chain: the
    # serial floor the LM step adds to; the beam decode for LM + beam), its
    # bound and its table's branch.
    coefs5003 = pack_coefs(c5003.log_a, c5003.lower_of_state, c5003.is_entry, c5003.is_exit,
                           device=dev)
    lm5003 = lm_tables(pair5003, c5003.word_of_state, c5003.uppers, device=dev)
    w5003 = len(c5003.labels)
    st5003 = stream_args(c5003, 64, lm5003)
    beam_big = 10.0
    # The BEAM decode mode past one warp (4 and 20 warps), beside the flat
    # decode mode at the same inputs; also the LM + beam rows' flat mode.
    beam503_ms = device_ms(lambda: tsf.scanfree_decode_beam(lb503, coefs503, c503.penalty,
                                                            len503, beam_big))
    beam5003_ms = device_ms(lambda: tsf.scanfree_decode_beam(lb5003, coefs5003, c5003.penalty,
                                                             len5003, beam_big), reps=5)
    flat503_ms = device_ms(lambda: tsf.scanfree_decode(lb503, coefs503, c503.penalty, len503))
    flat5003_ms = device_ms(lambda: tsf.scanfree_decode(lb5003, coefs5003, c5003.penalty,
                                                        len5003), reps=5)
    lm_rows = (
        ("trellis_decode_lm", f"B={b} T={t_total} S={s58} W={w58}", *timings["trellis_decode_lm"],
         flat_ms, yardsticks["trellis_decode_lm"][1:], tsf.lm_table_branch(t_total, s58, w58)),
        ("trellis_decode_lm", f"B=64 T={t_total} S={c503.num_states} W={w503}", *t503,
         flat503_ms, b503, tsf.lm_table_branch(t_total, c503.num_states, w503)),
        ("trellis_decode_lm", f"B=4 T=60 S={c5003.num_states} W={w5003}",
         device_ms(lambda: tsf.scanfree_decode_lm(lb5003, coefs5003, lm5003, len5003), reps=5),
         None, flat5003_ms, search_decode_bound(4, 60, c5003.num_states, len5003, w5003),
         tsf.lm_table_branch(60, c5003.num_states, w5003)),
        ("trellis_stream_lm", f"512 slots x 16 frames, S={s58}, W={w58}",
         *timings["trellis_stream_lm"], flat_stream_ms, yardsticks["trellis_stream_lm"][1:],
         tsf.lm_table_branch(16, s58, w58, decode=False)),
        ("trellis_stream_lm", f"256 slots x 16 frames, S={c503.num_states}, W={w503}", s503_ms,
         None, device_ms(lambda: tst.stream_advance(*st503[:7], c503.penalty)), s503_bound,
         tsf.lm_table_branch(16, c503.num_states, w503, decode=False)),
        ("trellis_stream_lm", f"64 slots x 16 frames, S={c5003.num_states}, W={w5003}",
         device_ms(lambda: tst.stream_advance_lm(*st5003)), None,
         device_ms(lambda: tst.stream_advance(*st5003[:7], c5003.penalty)),
         stream_lm_bound(64, 16, c5003.num_states, 4, w5003),
         tsf.lm_table_branch(16, c5003.num_states, w5003, decode=False)),
        ("trellis_decode_lm+beam", f"B={b} T={t_total} S={s58} W={w58} beam={beam_main}",
         device_ms(lambda: tsf.scanfree_decode_lm(lb3, coefs58, lm58, n_frames, beam=beam_main)),
         None, timings["trellis_decode_beam"][0],
         search_decode_bound(b, t_total, s58, n_frames, w58, beam=True),
         tsf.lm_table_branch(t_total, s58, w58)),
        ("trellis_decode_lm+beam", f"B=64 T={t_total} S={c503.num_states} W={w503} "
         f"beam={beam_big}",
         device_ms(lambda: tsf.scanfree_decode_lm(lb503, coefs503, lm503, len503, beam=beam_big)),
         None, beam503_ms,
         search_decode_bound(64, t_total, c503.num_states, len503, w503, beam=True),
         tsf.lm_table_branch(t_total, c503.num_states, w503)),
        ("trellis_decode_lm+beam", f"B=4 T=60 S={c5003.num_states} W={w5003} beam={beam_big}",
         device_ms(lambda: tsf.scanfree_decode_lm(lb5003, coefs5003, lm5003, len5003,
                                                  beam=beam_big), reps=5),
         None, beam5003_ms,
         search_decode_bound(4, 60, c5003.num_states, len5003, w5003, beam=True),
         tsf.lm_table_branch(60, c5003.num_states, w5003)),
        ("trellis_decode_beam", f"B=64 T={t_total} S={c503.num_states} beam={beam_big}",
         beam503_ms, None, flat503_ms,
         search_decode_bound(64, t_total, c503.num_states, len503, beam=True), None),
        ("trellis_decode_beam", f"B=4 T=60 S={c5003.num_states} beam={beam_big}",
         beam5003_ms, None, flat5003_ms,
         search_decode_bound(4, 60, c5003.num_states, len5003, beam=True), None),
    )
    for name, shape, ms, plain_ms, flat_mode_ms, (b_ms, b_by), tab in lm_rows:
        log("timing", kernel=name, shape=shape, ms=ms, plain_ms=plain_ms,
            flat_mode_ms=flat_mode_ms, bound_ms=b_ms, bound_by=b_by, table=tab)
    log("timing", what="searches at 64 clips, one clip for n-best and the forward lattice (all "
        "on their kernels: PLANES, DURATION, LSUM after K4 + K2-bt, KBEST, LMAX + LSUM)",
        search_ms=json.dumps(search_ms))
    errs.update(err)
    log("phase", which="22 search", seconds=f"{time.perf_counter() - t_phase:.2f}")


def constrained_split(dev, dec, clips, by_count, grammar, search_ms):
    """Phase 22's constrained decodes at 64 clips, their host wall split
    into the decoder's parts (ContinuousDecoder._constrained, rebuilt here
    with clocks; measurement only): pad and features' upload; host tables
    (chain_grammar / duration_arrays, planes_tables / duration_tables with
    routing_table); the tables' upload; emissions; the kernel and its walk;
    the readback and path_to_labels; the unconstrained fallback of rows
    with no admissible path. Device parts by CUDA events, host parts by the
    host clock after a synchronize; best of three passes."""
    from cs304_tpu_torch.data.batching import pad_batch
    from cs304_tpu_torch.ops import viterbi_counted as tvc
    from cs304_tpu_torch.ops import viterbi_duration as tvd
    from cs304_tpu_torch.ops.cuda import trellis_constrained as tcs

    c = dec.composite
    topo = (c.log_a, c.lower_of_state, c.is_entry, c.is_exit)
    counted = c.word_of_state != (c._silence_word if c._silence_word is not None else -1)

    def one(idx, kind):
        """One _constrained call's parts (ms) for clips idx."""
        parts = {}
        feats = [clips[i] for i in idx]

        def host(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        def device(name, fn):
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            out = fn()
            e1.record()
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + e0.elapsed_time(e1)
            parts[name + " (host)"] = (parts.get(name + " (host)", 0.0)
                                       + (time.perf_counter() - t0) * 1e3)
            return out

        padded = host("pad + features in", lambda: pad_batch([np.asarray(f) for f in feats], 128))
        batch, lengths = host("pad + features in", lambda: dec._to_device(padded))
        if kind == "duration":
            mn, mx, dc = host("host tables", lambda: tvd.duration_arrays(c, 2))
            ftab, ints = host("host tables", lambda: tcs.duration_tables(*topo, mn, mx))
            tabs = host("tables upload", lambda: tcs.duration_upload(ftab, ints, dc, dev))
        else:
            if kind == "grammar":
                word, ns, acc = c.word_of_state, grammar.next_state, grammar.accept
            else:
                word, ns, acc = host("host tables", lambda: tvc.chain_grammar(counted, kind))
            ftab, ints = host("host tables", lambda: tcs.planes_tables(*topo, word, ns, acc))
            tabs = host("tables upload", lambda: tcs.planes_upload(ftab, ints, dev))
        log_b = device("emissions", lambda: dec._emissions(batch))
        fwd = tcs.duration_forward if kind == "duration" else tcs.planes_forward
        scores, paths = device("kernel + walk", lambda: fwd(log_b, tabs, c.penalty, lengths))

        def readback():
            sc, pa = scores.cpu().numpy(), paths.cpu().numpy()
            return sc, [("".join(c.path_to_labels(pa[i, : padded.lengths[i]]))
                         if np.isfinite(sc[i]) else None) for i in range(len(feats))]

        sc, texts = host("readback + path_to_labels", readback)
        missing = [feats[i] for i in range(len(feats)) if texts[i] is None]
        if missing:
            host("fallback (unconstrained)", lambda: dec.predict_batch(missing))
        return parts

    runs = {
        "counted (64 clips, true counts)": [(idx, n) for n, idx in sorted(by_count.items())],
        "duration (64 clips, min 2)": [(list(range(len(clips))), "duration")],
        "grammar (64 clips, 6-string menu)": [(list(range(len(clips))), "grammar")],
    }
    for what, calls in runs.items():
        best = None
        for _ in range(3):
            parts = {}
            for idx, kind in calls:
                for k, v in one(idx, kind).items():
                    parts[k] = parts.get(k, 0.0) + v
            if best is None or sum(v for k, v in parts.items() if "(host)" not in k) < sum(
                    v for k, v in best.items() if "(host)" not in k):
                best = parts
        lead = max((k for k in best if "(host)" not in k), key=best.get)
        log("split", run=what, wall_ms=search_ms.get(what), lead=repr(lead),
            **{k.replace(" ", "_").replace("+", "and").replace("(", "").replace(")", ""): v
               for k, v in best.items()})


def search_split(dev, dec, clips, search_ms):
    """Phase 22's confidences (64 clips), n-best (one clip, n = 4) and
    forward lattice with posteriors (one clip) with their host wall split
    into their parts (ops/lattice.py word_confidences_batch and
    forward_lattice, ops/nbest.py nbest_decode rebuilt here with clocks;
    measurement only). Confidences: pad and features in, emissions (one
    call), the dense decode (K4 + K2-bt and the paths' readback), LSUM, the
    word-end lambdas formed on the card and their (B, T, W) readback, the
    host span walk (one mask over the padded paths, path_word_spans_batch);
    n-best: emissions, KBEST, the readback of alpha and bps, the host
    backtrace and dedupe; forward lattice: emissions, LMAX, the readback
    (the (T, S) alphas and entry times, beta_entry, the score), the Python
    arc loop, the posteriors' LSUM and their readback and lambdas
    (word_end_log_posteriors' host part). Device parts by CUDA
    events, host parts by the host clock after a synchronize; best of three
    passes."""
    from cs304_tpu_torch.data.batching import pad_batch
    from cs304_tpu_torch.ops import lattice as tla
    from cs304_tpu_torch.ops import nbest as tnb
    from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk

    comp = dec.composite

    def clocks(parts):
        def host(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        def device(name, fn):
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            out = fn()
            e1.record()
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + e0.elapsed_time(e1)
            parts[name + " (host)"] = (parts.get(name + " (host)", 0.0)
                                       + (time.perf_counter() - t0) * 1e3)
            return out
        return host, device

    def confidences():
        parts = {}
        host, device = clocks(parts)
        padded = host("pad + features in", lambda: pad_batch([np.asarray(f) for f in clips], 128))
        x, ln = host("pad + features in", lambda: (torch.as_tensor(padded.data, device=dev),
                                                   torch.as_tensor(padded.lengths, device=dev)))
        lb = device("emissions", lambda: comp.log_likelihoods(x))
        paths = device("K4 + K2-bt + paths readback", lambda: tla._viterbi_no_quirk(comp, lb, ln))
        out = device("LSUM", lambda: tla._sum_passes(comp, lb, ln))
        device("lambdas + readback",
               lambda: tla._word_end_lambdas(comp, out[0], out[2], out[3], ln).cpu().numpy())
        host("span walk", lambda: tla.path_word_spans_batch(comp, paths, padded.lengths))
        return parts

    def nbest():
        parts = {}
        host, device = clocks(parts)
        lb = device("emissions", lambda: comp.log_likelihoods(np.asarray(clips[0]), device=dev))
        topo = tlk.topology_of(comp, dev)
        alpha, bps = device("KBEST", lambda: tnb.kbest_composite_forward(
            lb, comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit, comp.penalty,
            k=8, topology=topo))
        a, b = device("alpha + bps readback", lambda: (alpha.cpu().numpy(), bps.cpu().numpy()))
        host("host backtrace + dedupe", lambda: [
            "".join(comp.path_to_labels(p))
            for _s, p in tnb.nbest_paths(a, b, comp.is_exit, lb.shape[0], 8)])
        return parts

    def lattice():
        parts = {}
        host, device = clocks(parts)
        feats = np.asarray(clips[0])
        t_total = feats.shape[0]
        lb = device("emissions", lambda: comp.log_likelihoods(feats, device=dev))
        out = device("LMAX", lambda: tla._lattice_passes(comp, lb.contiguous(), t_total))
        uppers = np.asarray(comp.uppers)
        cols = device("readback", lambda: (
            out[0].cpu().numpy()[:t_total, uppers], out[1].cpu().numpy()[:t_total, uppers],
            out[2].cpu().numpy(), float(out[3])))
        host("arc loop", lambda: tla._lattice_arcs(comp, *cols, 50.0, t_total))
        ln = torch.tensor([t_total], dtype=torch.int32, device=dev)
        sq = device("posteriors LSUM", lambda: tla._sum_passes(comp, lb[None].contiguous(), ln))

        def readback_and_lambdas():
            lb.cpu().numpy()
            alphas, _beta_em, beta_entry = (x[0].cpu().numpy() for x in sq[:3])
            log_z = float(sq[3][0])
            uppers = np.asarray(comp.uppers)
            lam = np.full((t_total, len(uppers)), -np.inf)
            a_exit = alphas[:t_total][:, uppers]
            lam[: t_total - 1] = (a_exit[: t_total - 1] + comp.penalty
                                  + beta_entry[1:t_total, None] - log_z)
            lam[t_total - 1] = a_exit[t_total - 1] - log_z
            return lam
        host("posteriors readback + lambdas", readback_and_lambdas)
        return parts

    for what, fn in (("confidences (64 clips)", confidences), ("nbest (1 clip, n=4)", nbest),
                     ("forward lattice + posteriors (1 clip)", lattice)):
        best = None
        for _ in range(3):
            parts = fn()
            if best is None or sum(v for k, v in parts.items() if "(host)" not in k) < sum(
                    v for k, v in best.items() if "(host)" not in k):
                best = parts
        lead = max((k for k in best if "(host)" not in k), key=best.get)
        log("split", run=what, wall_ms=search_ms.get(what), lead=repr(lead),
            **{k.replace(" ", "_").replace("+", "and").replace("(", "").replace(")", ""): v
               for k, v in best.items()})


def planes_step_ops(ftab, ints):
    """The FP32 adds and compares one step of PLANES needs on its host
    tables (trellis_constrained.planes_tables), each counted once:
    A  a compare a (plane, exit) for each plane's best exit;
    B  a compare a routed source plane, then the penalty added once a
       (plane, word) pair;
    C  at each cell with k stay candidates (c2, c1, c0 finite: j-2, j-1, j
       on the word's band, an entry's self-loop) k adds of the move and
       k - 1 compares, the log_b add, and at an entry one compare against
       its cross move (the penalty already added in B)."""
    k = np.isfinite(ftab[:3]).sum(0)
    entry = ints["itab"][0] >= 0
    g = len(ints["accept"])
    w = (len(ints["route_off"]) - 1) // g
    cell = k + np.maximum(k - 1, 0) + 1 + entry
    return int(g * cell.sum() + g * len(ints["exits"]) + len(ints["route_src"]) + g * w)


def duration_step_ops(ftab, ints, d):
    """The FP32 adds and compares one step of DURATION needs on its host
    tables (trellis_constrained.duration_tables) at D = d slots, each
    counted once:
    A  a compare a completed slot (d + 1 >= min_dur) of each state, then a
       penalty add and a compare an exit (the best exit sum);
    C  slot 0 of a non-entry j: k adds (the k finite advances from j-2,
       j-1) and k - 1 compares; of an entry that is an exit, an add and a
       compare each other exit (a plain entry takes A's best exit sum);
       slots d >= 1: the stay's add where d + 1 <= max_dur, a compare at
       the saturating slot D - 1 of an unbounded state; a log_b add a
       cell."""
    flags, lo, hi = ints["itab"].astype(np.int64)
    entry, exit_, unbounded = (flags & 1) > 0, (flags & 2) > 0, (flags & 4) > 0
    n_exit, s = len(ints["exits"]), ftab.shape[1]
    completed = np.clip(d - np.maximum(lo - 1, 0), 0, None).sum()
    k = np.isfinite(ftab[:2]).sum(0)
    advance = np.where(entry, np.where(exit_, 2 * (n_exit - 1), 0), k + np.maximum(k - 1, 0))
    stays = (np.arange(2, d + 1)[None, :] <= hi[:, None]).sum()
    saturate = unbounded.sum() if d >= 2 else 0
    return int(completed + 2 * n_exit + advance.sum() + stays + saturate + s * d)


def constrained_bound(b, t, s, lengths, cells, ops_step):
    """bound() of one constrained decode: the live log_b rows in, scores
    and paths out, and ops_step operations (planes_step_ops /
    duration_step_ops) a live step at PEAK_FP32_ALU, the t = 0 seed and
    the final left out; the same with one code byte a cell of every live
    step written once (the team branches' traffic); and with the int32
    backpointers instead (the simple branch's)."""
    live = int(lengths.clamp(min=1, max=t).sum().item())
    io = 4 * live * s + 4 * b * t + 4 * b
    ops = [((live - b) * ops_step, PEAK_FP32_ALU)]
    return (bound(io, ops), bound(io + (live - b) * cells, ops),
            bound(io + 4 * (live - b) * cells, ops))


def constrained_phase(dev, decode, pipe, timings, errs, yardsticks):
    """Phase 30: the PLANES kernel (counted and grammar decoding) and the
    DURATION kernel (csrc/trellis_constrained.cu) against their plain
    versions through the ops' dispatchers: scores bitwise with their signs
    of zero, paths on every finite row; the flagship on phase 6's emissions
    (a column slice of the padded log_b, read at its row stride) with ragged
    lengths and a length-1 row (no admissible path), integer ties; 503 and
    5003 states; the team branches' edges; the simple branch past the
    teams, walked by K2-bt and past its widest row by the forward. Each
    case logs its branch, its walk and its launches; then each kernel's
    device time (CUDA-graph replays of forward_branch on tables built once)
    in turns beside the simple branch's, its plain version's eager time,
    and its bound. First the main
    path's own inputs: the emissions phase 22's decodes hand the kernels
    (its 64 clips of phase 9's models, padded to 128 frames; counted by
    each clip's true count, the menu grammar, min 2)."""
    from cs304_tpu_torch.data.batching import pad_batch
    from cs304_tpu_torch.models import decoder as dm
    from cs304_tpu_torch.ops import grammar as tg
    from cs304_tpu_torch.ops import viterbi_counted as tvc
    from cs304_tpu_torch.ops import viterbi_duration as tvd
    from cs304_tpu_torch.ops.cuda import trellis_constrained as tcs
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf

    t_phase = time.perf_counter()
    flag, lb3 = decode["comp"], decode["lb3"]
    gen = torch.Generator(device=dev).manual_seed(30)
    err = {"trellis_planes": 0.0, "trellis_duration": 0.0}

    def topo(c):
        return c.log_a, c.lower_of_state, c.is_entry, c.is_exit

    def counted(comp, n, n_min=None):
        cw = comp.word_of_state != comp.labels.index("S")
        args = (*topo(comp), cw, comp.penalty, n)
        word, ns, acc = tvc.chain_grammar(cw, n, n_min)
        ops = planes_step_ops(*tcs.planes_tables(*topo(comp), word, ns, acc))
        return ("trellis_planes", (n + 1) * comp.num_states, ops,
                lambda lb, ln: tvc.viterbi_composite_counted_batch(lb, *args, ln,
                                                                   n_words_min=n_min),
                lambda lb, ln: tvc.viterbi_composite_counted_batch_plain(lb, *args, ln,
                                                                         n_words_min=n_min),
                lambda: tcs.planes_operands(*topo(comp), word, ns, acc, dev), comp.penalty)

    def grammar(comp, dfa):
        args = (*topo(comp), comp.word_of_state, dfa.next_state, dfa.accept)
        ops = planes_step_ops(*tcs.planes_tables(*args))
        return ("trellis_planes", dfa.num_planes * comp.num_states, ops,
                lambda lb, ln: tg.viterbi_composite_grammar_batch(lb, *args, comp.penalty, ln),
                lambda lb, ln: tg.viterbi_composite_grammar_batch_plain(lb, *args, comp.penalty,
                                                                        ln),
                lambda: tcs.planes_operands(*args, dev), comp.penalty)

    def duration(comp, min_d, max_d=None):
        mn, mx, dc = tvd.duration_arrays(comp, min_d, max_d)
        args = (*topo(comp), comp.penalty, mn, mx)
        ops = duration_step_ops(*tcs.duration_tables(*topo(comp), mn, mx), dc)
        return ("trellis_duration", comp.num_states * dc, ops,
                lambda lb, ln: tvd.viterbi_composite_duration_batch(lb, *args, ln, d_cap=dc),
                lambda lb, ln: tvd.viterbi_composite_duration_batch_plain(lb, *args, ln,
                                                                          d_cap=dc),
                lambda: tcs.duration_operands(*topo(comp), mn, mx, dc, dev), comp.penalty)

    def plan_of(key, tabs, t_k):
        planes = key == "trellis_planes"
        return (tcs.planes_plan if planes else tcs.duration_plan)(t_k, tabs.s, tabs.depth)

    def check(name, spec, log_b, lengths, no_path_rows=False, branch="team", walk="kernel",
              some_finite=True):
        key, cells, _ops, run, plain, tabs_fn, _pen = spec
        counter = tcs.planes_decode if key == "trellis_planes" else tcs.duration_decode
        before = (counter.launches, tsf.trellis_backtrace.launches)
        got = kernel_runs(key, run, log_b, lengths)[0]
        torch.cuda.synchronize()
        rose = {"kernel": counter.launches - before[0],
                "K2-bt": tsf.trellis_backtrace.launches - before[1]}
        want = plain_run(plain, log_b, lengths)
        torch.cuda.synchronize()
        finite = torch.isfinite(want[0])
        same = {"scores": torch.equal(got[0], want[0]),
                "score_signs": torch.equal(torch.signbit(got[0]), torch.signbit(want[0])),
                "finite_paths": torch.equal(got[1][finite], want[1][finite])}
        both = finite & torch.isfinite(got[0])
        e = (got[0] - want[0])[both].abs().max().item() if both.any() else 0.0
        err[key] = max(err[key], e)
        b_k, t_k, s_k = log_b.shape
        tabs = tabs_fn()
        plan = plan_of(key, tabs, t_k)
        took = tcs.walk_of(key == "trellis_planes", tabs, t_k, dev)
        log("constrained", case=name, kernel=key, branch=plan["branch"], B=b_k, T=t_k, S=s_k,
            cells=cells, walk=took, codes=plan["codes"], K=plan["k"], warps=plan["warps"],
            **({"ctas": plan["ctas"]} if "ctas" in plan else {"teams": plan["teams"]}),
            threads=plan["threads"], launches=json.dumps(rose), equal=json.dumps(same),
            finite_rows=finite.float().mean().item(), no_path_rows=int((~finite).sum()),
            max_abs_err=e)
        if not all(same.values()) or (some_finite and not finite.any()):
            raise SystemExit(f"phase 30: {key} disagrees with its plain version ({name}), or "
                             f"its case compares -inf alone")
        # One launch a call, the call made under each of the two poisons.
        n_runs = len(KERNEL_POISONS)
        if (rose != {"kernel": n_runs, "K2-bt": n_runs * int(took == "k2bt")}
                or plan["branch"] != branch or took != walk):
            raise SystemExit(f"phase 30: case {name} launched {rose} on the {plan['branch']} "
                             f"branch, walked by {took}, not the {branch} branch walked by "
                             f"{walk}")
        if no_path_rows and finite.all():
            raise SystemExit(f"phase 30: case {name} has no row without an admissible path")

    def ragged(nb, t):
        ln = torch.randint(1, t + 1, (nb,), generator=gen, device=dev, dtype=torch.int32)
        ln[0] = t
        if nb > 2:
            ln[1] = 1  # too short for any admissible path
        return ln

    # The main path's inputs, as ContinuousDecoder._constrained makes them.
    main_dec = dm.ContinuousDecoder(pipe["models"], penalty=-100.0, device=dev)
    pc = main_dec.composite
    truths = pipe["eval"]["train_speakers"][0] + pipe["eval"]["unseen_speakers"][0]
    feats = pipe["eval"]["train_speakers"][1] + pipe["eval"]["unseen_speakers"][1]
    clips, clip_truths = (feats * 2)[:64], (truths * 2)[:64]

    def main_inputs(idx):
        batch, lengths = main_dec._to_device(pad_batch([np.asarray(clips[i]) for i in idx],
                                                       128))
        return main_dec._emissions(batch), lengths

    menu_main = tg.WordDFA.from_strings(PIPELINE_TRANSCRIPTS, pc.labels)
    lb_main, len_main = main_inputs(range(len(clips)))
    by_count = {}
    for i, tr in enumerate(clip_truths):
        by_count.setdefault(len(tr), []).append(i)
    main_counted = {n: main_inputs(idx) for n, idx in sorted(by_count.items())}
    for n, (lb_n, len_n) in main_counted.items():
        check(f"main-counted-{n}", counted(pc, n), lb_n, len_n)
    check("main-menu", grammar(pc, menu_main), lb_main, len_main)
    check("main-duration-min-2", duration(pc, 2), lb_main, len_main)

    s58, t_total = flag.num_states, lb3.shape[1]
    digits = [lab for lab in flag.labels if lab != "S"]
    menu = tg.WordDFA.from_strings(PIPELINE_TRANSCRIPTS, flag.labels)
    lb58 = lb3[:128, :, :s58]  # phase 6's emissions at their row stride of 128
    len58 = ragged(128, t_total)
    ties58 = torch.randint(-3, 1, (128, t_total, s58), generator=gen, device=dev).float()
    for n in range(1, 8):
        check(f"flagship-counted-{n}", counted(flag, n), lb58, len58, no_path_rows=True)
    check("flagship-count-range-2-7", counted(flag, 7, 2), lb58, len58, no_path_rows=True)
    check("flagship-counted-3-ties", counted(flag, 3), ties58, len58, no_path_rows=True)
    check("flagship-menu", grammar(flag, menu), lb58, len58, no_path_rows=True)
    check("flagship-menu-ties", grammar(flag, menu), ties58, len58, no_path_rows=True)
    check("flagship-duration-min-2", duration(flag, 2), lb58, len58, no_path_rows=True)
    check("flagship-duration-min-3-max-6-a-word",
          duration(flag, {w: 3 for w in digits}, {w: 6 for w in digits}), lb58, len58,
          no_path_rows=True)
    check("flagship-duration-ties", duration(flag, 2, 4), ties58, len58, no_path_rows=True)
    c503, c5003 = random_composite(100, 3), random_composite(1000, 3)
    rng = np.random.default_rng(30)
    vocab = [lab for lab in c503.labels if lab != "S"]
    pos503 = tg.WordDFA.from_positions(
        [tuple(rng.choice(vocab, size=len(vocab) // 3, replace=False)) for _ in range(3)],
        c503.labels)
    lb503 = 3 * torch.randn((16, t_total, c503.num_states), generator=gen, device=dev)
    len503 = ragged(16, t_total)
    for n in (2, 4):
        check(f"503-counted-{n}", counted(c503, n), lb503, len503, no_path_rows=True)
    check("503-count-range-1-4", counted(c503, 4, 1), lb503, len503, no_path_rows=True)
    check("503-positions", grammar(c503, pos503), lb503, len503, no_path_rows=True)
    check("503-duration-min-2", duration(c503, 2), lb503, len503, no_path_rows=True)
    check("503-duration-min-3-max-6", duration(c503, 3, 6), lb503, len503, no_path_rows=True)
    lb5003 = 3 * torch.randn((2, 60, c5003.num_states), generator=gen, device=dev)
    len5003 = ragged(2, 60)
    check("5003-counted-2", counted(c5003, 2), lb5003, len5003, branch="cluster")
    check("5003-duration-min-2", duration(c5003, 2), lb5003, len5003)
    # 30,018 cells: past K2-bt's rows the PR-19 forward walked; the team does.
    check("5003-duration-min-3-max-6", duration(c5003, 3, 6), lb5003, len5003)
    # The edges of the team branches: B = 1; T = 1 with a length-0 row; a
    # length-0 row among ragged lengths; a cluster of two CTAs at 503 states
    # (10 planes of 4 warps); 8 slots a state at 503 and 5003 states (the
    # 5003-state slots in shared memory); the kept PR-19 kernels (the
    # simple branch) past the teams: more planes than a cross code names
    # (65 planes, walked by K2-bt; 501 planes x 58 states = 29,058 cells,
    # past K2-bt's widest row, walked by the forward) and more slots than a
    # team holds (D = 9: 4,527 cells at 503 states, walked by K2-bt; 45,027
    # at 5003, walked by the forward).
    check("flagship-counted-2-B1", counted(flag, 2), lb58[:1], len58[:1])
    len_t1 = torch.ones(16, dtype=torch.int32, device=dev)
    len_t1[3] = 0
    check("flagship-counted-1-T1", counted(flag, 1), lb58[:16, :1], len_t1, some_finite=False)
    check("flagship-duration-min-2-T1", duration(flag, 2), lb58[:16, :1], len_t1,
          some_finite=False)
    len_zero = len58.clone()
    len_zero[2] = 0
    check("flagship-counted-3-zero-row", counted(flag, 3), lb58, len_zero, no_path_rows=True)
    check("flagship-duration-min-2-zero-row", duration(flag, 2), lb58, len_zero,
          no_path_rows=True)
    check("503-counted-9-cluster", counted(c503, 9), lb503[:4], len503[:4], branch="cluster")
    check("503-duration-min-3-max-8", duration(c503, 3, 8), lb503, len503, no_path_rows=True)
    check("5003-duration-min-3-max-8", duration(c5003, 3, 8), lb5003, len5003)
    check("5003-counted-3-B1", counted(c5003, 3), lb5003[:1], len5003[:1], branch="cluster")
    check("flagship-count-range-1-64-simple", counted(flag, 64, 1), lb58[:16], len58[:16],
          branch="simple", walk="k2bt")
    check("flagship-count-range-1-500-simple", counted(flag, 500, 1), lb58[:16], len58[:16],
          branch="simple", walk="forward")
    check("503-duration-min-3-max-9-simple", duration(c503, 3, 9), lb503, len503,
          no_path_rows=True, branch="simple", walk="k2bt")
    check("5003-duration-min-3-max-9-simple", duration(c5003, 3, 9), lb5003, len5003,
          branch="simple", walk="forward")

    # -- timing: device time on tables built once, beside the plain loop -----
    lb64, len64 = lb3[:64, :, :s58], decode["n_frames"][:64]
    t_main = lb_main.shape[1]
    rows = (
        ("trellis_planes", f"phase 22's menu grammar ({menu_main.num_planes} planes), "
         f"B=64, T={t_main}", grammar(pc, menu_main), lb_main, len_main),
        ("trellis_duration", f"phase 22's min 2 (D=2), B=64, T={t_main}", duration(pc, 2),
         lb_main, len_main),
        *(("trellis_planes", f"phase 22's counted N={n} ({n + 1} planes), "
           f"B={lb_n.shape[0]}, T={lb_n.shape[1]}", counted(pc, n), lb_n, len_n)
          for n, (lb_n, len_n) in main_counted.items()),
        ("trellis_planes", "flagship counted N=7 (8 planes), B=64, T=201", counted(flag, 7),
         lb64, len64),
        ("trellis_planes", f"flagship menu ({menu.num_planes} planes), B=64, T=201",
         grammar(flag, menu), lb64, len64),
        ("trellis_planes", "503 states counted N=4, B=16, T=201", counted(c503, 4), lb503,
         len503),
        ("trellis_planes", "5003 states counted N=2, B=2, T=60", counted(c5003, 2), lb5003,
         len5003),
        ("trellis_duration", "flagship min 2 (D=2), B=64, T=201", duration(flag, 2), lb64,
         len64),
        ("trellis_duration", "503 states min 3 max 6 (D=6), B=16, T=201",
         duration(c503, 3, 6), lb503, len503),
        ("trellis_duration", "5003 states min 2 (D=2), B=2, T=60", duration(c5003, 2), lb5003,
         len5003),
    )
    # Each row in turns, the PR-19 kernel (the simple branch, forced: its
    # forward and K2-bt or its own walk) and the team branch, a n n a.
    for key, shape, (_k, cells, per_step, _run, plain, tabs_fn, pen), lb, ln in rows:
        tabs = tabs_fn()
        planes = key == "trellis_planes"
        b_k, t_k, s_k = lb.shape

        def fwd(simple):
            return lambda: tcs.forward_branch(planes, lb, tabs, pen, ln, simple=simple)

        turns = [device_ms(fwd(simple), reps=5) for simple in (True, False, False, True)]
        ms, parent_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        plain_ms = cuda_ms(lambda: plain(lb, ln), reps=2)
        (b_ms, b_by), (bc_ms, _by), (bp_ms, _by) = constrained_bound(b_k, t_k, s_k, ln, cells,
                                                                      per_step)
        plan = plan_of(key, tabs, t_k)
        res = constrained_resources(key, tabs, t_k, pen)
        steps = int(ln.clamp(max=t_k).max()) - 1
        log("timing", kernel=key, shape=shape, branch=plan["branch"], ms=ms,
            ms_turns=json.dumps([turns[1], turns[2]]), parent_ms=parent_ms,
            parent_turns=json.dumps([turns[0], turns[3]]), plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, bound_with_codes_ms=bc_ms, bound_with_backpointers_ms=bp_ms,
            us_per_step=ms / steps * 1e3, parent_us_per_step=parent_ms / steps * 1e3,
            slower_than_parent=min(turns[1:3]) > max(turns[0], turns[3]),
            **{f"team_{k}": v for k, v in res["team"].items()},
            **{f"parent_{k}": v for k, v in res["simple"].items()})
        if key not in timings:  # the first row of each kernel is its record
            timings[key] = (ms, plain_ms)
            yardsticks[key] = (None, b_ms, b_by)
    errs.update(err)
    log("phase", which="30 constrained", seconds=f"{time.perf_counter() - t_phase:.2f}")


# LSUM on the card against its plain version (csrc/trellis_lattice.cu): the
# same -inf cells, the rest within LSUM_REL * max(1, |x|) (expf / logf
# rounding; the sums run in the same order).
LSUM_REL = 1e-5


def lattice_composite(counts, penalty=-100.0, seed=31):
    """A composite of words with these state counts: the lattice kernels take
    its topology only (log_b is given), so the words' densities are random."""
    from cs304_tpu_torch.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a

    rng = np.random.default_rng(seed)
    return stack_word_models(
        [WordHMM(f"w{i}", rng.normal(size=(n, 4)).astype(np.float32),
                 np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)), uniform_forward_log_a(n))
         for i, n in enumerate(counts)], penalty=penalty)


def lattice_sum_bound(b, t, topo, lengths):
    """bound() of one LSUM call: log_b read and alphas and beta_em written
    (B, T, S each), beta_entry, log Z, lengths and the topology table; and
    the operations at PEAK_FP32_ALU, an add, a max, an exp or a log one
    each: a live forward step 16 a non-entry cell and 4 W_x + 8 an entry's
    (its exits' add, subtract, exp and add), a backward step (all T - 1) 16
    a non-exit row and 4 W_e + 20 an exit's, and beta_entry's and log Z's
    sums 4 W a row. A pool past DENSE_POOL_MAX members is factorized: 4 W
    a step once, and 12 (forward) or 24 (backward) a pool cell."""
    from cs304_tpu_torch.ops.cuda.trellis_lattice import DENSE_POOL_MAX

    s, wx, we = topo.num_states, topo.exits.numel(), topo.entries.numel()
    fwd = int((lengths.clamp(min=1, max=t) - 1).sum().item())
    f_entry, f_pool = (4 * wx + 8, 0) if wx <= DENSE_POOL_MAX else (12, 4 * wx)
    b_exit, b_pool = (4 * we + 20, 0) if we <= DENSE_POOL_MAX else (24, 4 * we)
    ops = (fwd * ((s - we) * 16 + we * f_entry + f_pool)
           + b * (t - 1) * ((s - wx) * 16 + wx * b_exit + b_pool) + 4 * (b * t * we + b * wx))
    return bound(12 * b * t * s + 4 * b * t + 8 * b + 52 * s + 4 * (wx + we),
                 [(ops, PEAK_FP32_ALU)])


def lattice_max_bound(t, topo, length):
    """bound() of one LMAX call: log_b read, alphas and entry times written
    (T, S each), beta_entry, the topology table; and at PEAK_FP32_ALU a live
    forward step's 6 operations a state (three adds, two compares, the
    emission's add), an exit's add and compare into the pool and an entry's
    compare, and a backward step's 6 a state and a compare an exit and an
    entry."""
    s, wx, we = topo.num_states, topo.exits.numel(), topo.entries.numel()
    live = max(min(int(length), t), 1) - 1
    ops = live * (6 * s + 2 * wx + we) + (t - 1) * (6 * s + wx + we)
    return bound(12 * t * s + 4 * t + 52 * s + 4 * (wx + we), [(ops, PEAK_FP32_ALU)])


def kbest_bound(t, topo, k):
    """bound() of one KBEST call: log_b read, bps (T, S, K) and alpha (S, K)
    written, the topology table; and at PEAK_FP32_ALU a step's 6 K
    operations a state (its candidates' adds, the merge's compares, the
    emission's add) and a compare a value of the exit pool (W_x K)."""
    s, wx = topo.num_states, topo.exits.numel()
    return bound(4 * t * s + 4 * t * s * k + 4 * s * k + 36 * s + 4 * wx,
                 [((t - 1) * (6 * k * s + wx * k), PEAK_FP32_ALU)])


def lattice_resources(kernel, s, plan):
    """ptxas' registers and spills of the instantiations a launch at S
    states takes, on the team branch (the plan's lattice_sum_team_kernel<K,
    bucket, cells a lane> / lattice_max_team_kernel<K, dense pool, cells a
    lane, CTAs> / kbest_team_kernel<bucket>) and on the simple branch (the first
    design's lattice_sum_kernel<K> / lattice_max_kernel<K> / kbest_kernel,
    K states a thread)."""
    from cs304_tpu_torch.ops.cuda import _build

    path = _build.library_path().with_suffix(".log")
    text = path.read_text() if path.exists() else ""
    k = 1 if s <= 1024 else 2 if s <= 2048 else 4 if s <= 4096 else 8
    if kernel == "kbest":
        team, simple = rf"kbest_team_kernelILi{plan['bucket']}E", r"kbest_kernelE"
    elif kernel == "lattice_max":
        team = (rf"lattice_max_team_kernelILi{plan['k']}ELb{int(plan['pool'] == 'dense')}E"
                rf"Li{plan['cells_a_lane']}ELi{plan['ctas']}E")
        simple = rf"lattice_max_kernelILi{k}E"
    else:
        team = (rf"lattice_sum_team_kernelILi{plan['k']}ELi{plan['bucket']}E"
                rf"Li{plan['cells_a_lane']}E")
        simple = rf"lattice_sum_kernelILi{k}E"
    return {"team": (ptxas_resources(text, re.compile(team)) if plan["branch"] == "team"
                     else {}),
            "simple": ptxas_resources(text, re.compile(simple))}


def lattice_skeleton_ms(dev, blocks, pair, threads, steps, barriers, ctas=1):
    """Device time of a team step's skeleton (cs304_lattice_skeleton: the
    same grid and threads, `barriers` barriers and shared exchanges a step
    and nothing else; cs304_lattice_cluster_skeleton on a cluster of `ctas`
    CTAs a pass, one cluster barrier a step) over `steps` steps: the step's
    serial floor."""
    from cs304_tpu_torch.ops.cuda import _build

    lib = _build.load()
    out = torch.empty(blocks * threads * (2 if pair else 1) * ctas, device=dev)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if ctas > 1:
            _build.check(lib.cs304_lattice_cluster_skeleton(ctas, threads, steps, out.data_ptr(),
                                                            stream), "lattice_cluster_skeleton")
        else:
            _build.check(lib.cs304_lattice_skeleton(blocks, int(pair), threads, steps, barriers,
                                                    out.data_ptr(), stream), "lattice_skeleton")
    return device_ms(run, reps=5)


def tensor_bits_equal(a, b):
    """Equal values with their signs of zero (floats), or equal integers."""
    if a.dtype.is_floating_point:
        return torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))
    return torch.equal(a, b)


def lattice_phase(dev, decode, pipe, launches, timings, errs, yardsticks):
    """Phase 31: the posterior and n-best searches' kernels
    (csrc/trellis_lattice.cu) against their plain versions through their
    dispatchers (ops/cuda/trellis_lattice.py): LSUM (the sum passes) with the
    same -inf cells and the rest within LSUM_REL * max(1, |x|), LMAX (the
    max-plus passes) and KBEST (the k-best forward) bitwise, every row past
    the lengths included. First on the main path's own inputs (phase 22's
    64 clips of phase 9's models, 128-padded and scored in one call as
    word_confidences_batch does; its first clip for LMAX and for KBEST at
    K = 8, predict_nbest(n=4)'s), then the flagship on phase 6's emissions
    (B = 64, T = 201; K = 6 and 16, --nbest 3's and nbest_lattice's), 375
    states (B = 16, T = 201), 503 states (B = 16, T = 201), 5003 states (B =
    2, T = 60); the edges: single-state words whose self-loop beats the
    penalty and whose penalty beats it, length-2 rows, integer-valued
    emissions for ties, K = 1 / 2 / 4 / 6 / 16 / 32 / 33, T = 1; LMAX also
    at 1503 and 3003 states (2 and 4 states a band thread on one CTA), 5000
    states of 20 long words (a dense pool folded on a cluster of two CTAs)
    and 8188 states (T = 30), near the largest S the kernels take. Each case
    logs its launches, its error and its plan's branch, LMAX on its plan's
    branch (asserted where the case names one) and on the first design
    (simple=True), both bitwise; then each
    kernel's device time (CUDA-graph replays) beside its plain loop's eager
    time, its bound, µs a step and ptxas' registers and spills of both
    builds, in turns p n n p beside its first design (simple=True, the
    parent) with the serial floor of the step's skeleton at the plan's
    threads."""
    from cs304_tpu_torch.data.batching import pad_batch
    from cs304_tpu_torch.models import decoder as dm
    from cs304_tpu_torch.ops.cuda import _build
    from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(31)
    err = {"lattice_sum": 0.0, "lattice_max": 0.0, "kbest": 0.0}
    plain_ms = {}

    def topo_of(comp):
        return tlk.lattice_topology(comp.log_a, comp.lower_of_state, comp.is_entry,
                                    comp.is_exit, comp.word_of_state, device=dev)

    def plain_timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_run(fn)
        torch.cuda.synchronize()
        plain_ms[key] = (time.perf_counter() - t0) * 1e3
        return out

    def check_sum(name, comp, lb, ln, some_finite=True):
        topo = topo_of(comp)
        before = tlk.lattice_sum_passes.launches
        got = kernel_runs("lattice_sum", tlk.lattice_sum_passes, lb, topo, comp.penalty, ln)[0]
        torch.cuda.synchronize()
        rose = (tlk.lattice_sum_passes.launches - before) // len(KERNEL_POISONS)
        want = plain_timed(("lattice_sum", name),
                           lambda: tlk.lattice_sum_passes_plain(lb, topo, comp.penalty, ln))
        same_inf, bitwise, worst, e = True, True, 0.0, 0.0
        for g, w in zip(got, want):
            same_inf &= torch.equal(torch.isfinite(g), torch.isfinite(w))
            bitwise &= tensor_bits_equal(g, w)
            fin = torch.isfinite(g) & torch.isfinite(w)
            if fin.any():
                d = (g - w)[fin].abs()
                e = max(e, d.max().item())
                worst = max(worst, (d / w[fin].abs().clamp(min=1.0)).max().item())
        err["lattice_sum"] = max(err["lattice_sum"], e)
        b_k, t_k, s_k = lb.shape
        plan = tlk.lattice_sum_plan(s_k, topo.exits.numel(), topo.entries.numel())
        log("lattice", case=name, kernel="lattice_sum", B=b_k, T=t_k, S=s_k,
            exits=topo.exits.numel(), branch=plan["branch"], bucket=plan["bucket"], launches=rose, same_inf_cells=same_inf, bitwise=bitwise,
            max_abs_err=e, max_rel_err=worst, finite_log_z=int(torch.isfinite(want[3]).sum()))
        if rose != 1 or not same_inf or worst > LSUM_REL or (some_finite and not
                                                             torch.isfinite(want[3]).any()):
            raise SystemExit(f"phase 31: LSUM disagrees with its plain version ({name}): "
                             f"launches {rose}, same -inf cells {same_inf}, rel {worst}")

    def check_max(name, comp, lb, length, expect=None):
        topo = topo_of(comp)
        before = tlk.lattice_max_passes.launches
        got = {simple: kernel_runs("lattice_max", tlk.lattice_max_passes, lb, topo,
                                   comp.penalty, length, simple=simple)[0]
               for simple in (False, True)}
        torch.cuda.synchronize()
        rose = (tlk.lattice_max_passes.launches - before) // len(KERNEL_POISONS)
        want = plain_timed(("lattice_max", name),
                           lambda: tlk.lattice_max_passes_plain(lb, topo, comp.penalty, length))
        names = ("alphas", "ets", "beta_entry", "score")
        same = {("simple_" if simple else "") + n: tensor_bits_equal(g, w)
                for simple, out in got.items() for n, g, w in zip(names, out, want)}
        e = 0.0
        for out in got.values():
            fin = torch.isfinite(out[0]) & torch.isfinite(want[0])
            if fin.any():
                e = max(e, (out[0] - want[0])[fin].abs().max().item())
        err["lattice_max"] = max(err["lattice_max"], e)
        plan = tlk.lattice_max_plan(lb.shape[1], topo.exits.numel(), topo.entries.numel())
        log("lattice", case=name, kernel="lattice_max", T=lb.shape[0], S=lb.shape[1],
            length=length, branch=plan["branch"], pool=plan["pool"], k=plan["k"],
            threads=plan["threads"], ctas=plan["ctas"], launches=rose, equal=json.dumps(same),
            max_abs_err=e,
            score=want[3].item())
        if rose != 2 or not all(same.values()) or (lb.shape[0] > 1 and
                                                   not torch.isfinite(want[3]).item()):
            raise SystemExit(f"phase 31: LMAX disagrees with its plain version ({name})")
        if expect and any(plan[k_] != v for k_, v in expect.items()):
            raise SystemExit(f"phase 31: LMAX's plan at {name} is {plan}, not {expect}")

    def check_kbest(name, comp, lb, k, length=None):
        topo = topo_of(comp)
        before = tlk.kbest_forward.launches
        got = kernel_runs("kbest", tlk.kbest_forward, lb, topo, comp.penalty, k, length)[0]
        torch.cuda.synchronize()
        rose = (tlk.kbest_forward.launches - before) // len(KERNEL_POISONS)
        want = plain_timed(("kbest", name),
                           lambda: tlk.kbest_forward_plain(lb, topo, comp.penalty, k, length))
        same = {"alpha": tensor_bits_equal(got[0], want[0]),
                "bps": tensor_bits_equal(got[1], want[1])}
        fin = torch.isfinite(got[0]) & torch.isfinite(want[0])
        e = (got[0] - want[0])[fin].abs().max().item() if fin.any() else 0.0
        err["kbest"] = max(err["kbest"], e)
        plan = tlk.kbest_plan(lb.shape[1], k, topo.exits.numel())
        log("lattice", case=name, kernel="kbest", T=lb.shape[0], S=lb.shape[1], K=k,
            length=length, launches=rose, equal=json.dumps(same), max_abs_err=e,
            branch=plan["branch"], bucket=plan["bucket"], rows=plan["rows"],
            finite_slots=int(fin.sum()))
        if rose != 1 or not all(same.values()) or not torch.isfinite(want[0]).any():
            raise SystemExit(f"phase 31: KBEST disagrees with its plain version ({name})")

    def ragged(nb, t, floor=2):
        ln = torch.randint(floor, t + 1, (nb,), generator=gen, device=dev, dtype=torch.int32)
        ln[0] = t
        return ln

    # The main path's inputs, as word_confidences_batch and predict_nbest
    # make them: phase 22's 64 clips, padded to 128 frames, scored in one call.
    main_dec = dm.ContinuousDecoder(pipe["models"], penalty=-100.0, device=dev)
    pc = main_dec.composite
    feats = pipe["eval"]["train_speakers"][1] + pipe["eval"]["unseen_speakers"][1]
    clips = (feats * 2)[:64]
    padded = pad_batch([np.asarray(c) for c in clips], 128)
    lb_main = pc.log_likelihoods(torch.as_tensor(padded.data, device=dev))
    len_main = torch.as_tensor(padded.lengths, device=dev)
    lb_clip = pc.log_likelihoods(np.asarray(clips[0]), device=dev)
    check_sum("main-confidences-64-clips", pc, lb_main, len_main)
    check_max("main-forward-lattice-clip-0", pc, lb_clip, lb_clip.shape[0])
    check_kbest("main-nbest-clip-0-K8", pc, lb_clip, 8)

    flag, lb3, n_frames = decode["comp"], decode["lb3"], decode["n_frames"]
    s58, t_total = flag.num_states, lb3.shape[1]
    lb58 = lb3[:64, :, :s58].contiguous()
    len58 = n_frames[:64].to(torch.int32).contiguous()
    check_sum("flagship-B64", flag, lb58, len58)
    check_max("flagship", flag, lb58[0].contiguous(), int(len58[0]))
    for k in (6, 8, 16):
        check_kbest(f"flagship-K{k}", flag, lb58[1].contiguous(), k, int(len58[1]))
    c375 = lattice_composite([5] * 75)
    c503, c5003 = random_composite(100, 3), random_composite(1000, 3)
    lb375 = 3 * torch.randn((16, t_total, c375.num_states), generator=gen, device=dev)
    len375 = ragged(16, t_total)
    lb503 = 3 * torch.randn((16, t_total, c503.num_states), generator=gen, device=dev)
    len503 = ragged(16, t_total)
    lb5003 = 3 * torch.randn((2, 60, c5003.num_states), generator=gen, device=dev)
    len5003 = ragged(2, 60)
    for name, comp, lb, ln in (("375", c375, lb375, len375), ("503", c503, lb503, len503),
                               ("5003", c5003, lb5003, len5003)):
        check_sum(f"{name}-states", comp, lb, ln)
        check_max(f"{name}-states", comp, lb[0].contiguous(), int(ln[0]))
        check_kbest(f"{name}-states-K8", comp, lb[1].contiguous(), 8, int(ln[1]))
    check_kbest("5003-states-K16", c5003, lb5003[0].contiguous(), 16)
    # LMAX at each width of its team branch: 2 and 4 states a band thread on
    # one CTA, a dense pool of long words folded on a cluster, and near the
    # largest S the kernels take (a cluster of four).
    c1503, c3003 = random_composite(300, 3), random_composite(600, 3)
    c_long = lattice_composite([250] * 20)
    c8188 = lattice_composite([5] * 1637 + [3])
    lb1503 = 3 * torch.randn((t_total, c1503.num_states), generator=gen, device=dev)
    lb3003 = 3 * torch.randn((100, c3003.num_states), generator=gen, device=dev)
    # A 250-state word takes at least 125 frames.
    lb_long = 3 * torch.randn((150, c_long.num_states), generator=gen, device=dev)
    lb8188 = 3 * torch.randn((30, c8188.num_states), generator=gen, device=dev)
    check_max("1503-states", c1503, lb1503, t_total,
              {"branch": "team", "k": 2, "ctas": 1, "cells_a_lane": 2})
    check_max("3003-states", c3003, lb3003, 100,
              {"branch": "team", "k": 4, "ctas": 1, "cells_a_lane": 4})
    check_max("long-words-5000-states", c_long, lb_long, 150,
              {"branch": "team", "k": 4, "ctas": 2, "pool": "factorized", "cells_a_lane": 1})
    check_max("8188-states", c8188, lb8188, 30,
              {"branch": "team", "k": 4, "ctas": 4, "cells_a_lane": 8})

    # The edges: single-state words (their self-loop 0 beats a -25 penalty,
    # or a 0 penalty beats it), length-2 rows, integer ties, K = 1, T = 1.
    ties58 = torch.randint(-3, 1, (16, 64, s58), generator=gen, device=dev).float()
    len_ties = ragged(16, 64)
    len_ties[1:4] = 2
    check_sum("flagship-ties-length-2-rows", flag, ties58, len_ties)
    check_max("flagship-ties", flag, ties58[0].contiguous(), 64)
    check_max("flagship-length-2", flag, ties58[1].contiguous(), 2)
    for k in (1, 2, 4, 6, 16, 32, 33):  # every K bucket and one past the largest
        check_kbest(f"flagship-ties-K{k}", flag, ties58[2].contiguous(), k, 50)
    for pen in (-25.0, 0.0):
        single = lattice_composite([1, 3, 1, 5, 1, 3], penalty=pen)
        lb_1 = torch.randint(-3, 1, (8, 64, single.num_states), generator=gen,
                             device=dev).float()
        len_1 = ragged(8, 64)
        len_1[2] = 2
        check_sum(f"single-state-words-pen{pen:g}", single, lb_1, len_1)
        check_max(f"single-state-words-pen{pen:g}", single, lb_1[0].contiguous(), 64)
        for k in (1, 6, 16):
            check_kbest(f"single-state-words-pen{pen:g}-K{k}", single, lb_1[1].contiguous(), k)
    check_sum("flagship-T1", flag, lb58[:4, :1].contiguous(),  # only entries live: Z = 0
              torch.ones(4, dtype=torch.int32, device=dev), some_finite=False)
    check_max("flagship-T1", flag, lb58[0, :1].contiguous(), 1)
    check_kbest("flagship-T1-K8", flag, lb58[0, :1].contiguous(), 8)

    # -- timing: device time (CUDA-graph replays) beside the plain loop; each
    # kernel in turns beside its first design (simple=True), p n n p ----------
    tp_main, tp58 = topo_of(pc), topo_of(flag)
    tp503, tp5003, tp8188 = topo_of(c503), topo_of(c5003), topo_of(c8188)
    tp1503, tp3003, tp_long = topo_of(c1503), topo_of(c3003), topo_of(c_long)
    len0 = lb_clip.shape[0]
    # Host ints before any capture: a capture may not synchronize.
    l58, l58b, l503, l503b, l5003 = (int(x) for x in (len58[0], len58[1], len503[0],
                                                      len503[1], len5003[0]))

    def lsum(lb, tp, pen, ln):
        return lambda simple: lambda: tlk.lattice_sum_passes(lb, tp, pen, ln, simple=simple)

    def lmax(lb, tp, pen, n):
        return lambda simple: lambda: tlk.lattice_max_passes(lb, tp, pen, n, simple=simple)

    def kbest(lb, tp, pen, k, n=None):
        return lambda simple: lambda: tlk.kbest_forward(lb, tp, pen, k, n, simple=simple)

    rows = (
        ("lattice_sum", "main-confidences-64-clips", f"phase 22's 64 clips, B=64, "
         f"T={lb_main.shape[1]}, S={pc.num_states}",
         lsum(lb_main, tp_main, pc.penalty, len_main),
         lattice_sum_bound(64, lb_main.shape[1], tp_main, len_main), lb_main.shape[1] - 1,
         tp_main, 64, None),
        ("lattice_sum", "flagship-B64", f"flagship B=64, T={t_total}, S={s58}",
         lsum(lb58, tp58, flag.penalty, len58),
         lattice_sum_bound(64, t_total, tp58, len58), t_total - 1, tp58, 64, None),
        ("lattice_sum", "503-states", f"503 states B=16, T={t_total}",
         lsum(lb503, tp503, c503.penalty, len503),
         lattice_sum_bound(16, t_total, tp503, len503), t_total - 1, tp503, 16, None),
        ("lattice_sum", "5003-states", "5003 states B=2, T=60",
         lsum(lb5003, tp5003, c5003.penalty, len5003),
         lattice_sum_bound(2, 60, tp5003, len5003), 59, tp5003, 2, None),
        ("lattice_max", "main-forward-lattice-clip-0", f"phase 22's clip 0, T={len0}",
         lmax(lb_clip, tp_main, pc.penalty, len0),
         lattice_max_bound(len0, tp_main, len0), len0 - 1, tp_main, 1, None),
        ("lattice_max", "flagship", f"flagship T={t_total}, length {l58}",
         lmax(lb58[0], tp58, flag.penalty, l58),
         lattice_max_bound(t_total, tp58, l58), t_total - 1, tp58, 1, None),
        ("lattice_max", "503-states", f"503 states T={t_total}",
         lmax(lb503[0], tp503, c503.penalty, l503),
         lattice_max_bound(t_total, tp503, l503), t_total - 1, tp503, 1, None),
        ("lattice_max", "1503-states", f"1503 states T={t_total}",
         lmax(lb1503, tp1503, c1503.penalty, t_total),
         lattice_max_bound(t_total, tp1503, t_total), t_total - 1, tp1503, 1, None),
        ("lattice_max", "3003-states", "3003 states T=100",
         lmax(lb3003, tp3003, c3003.penalty, 100),
         lattice_max_bound(100, tp3003, 100), 99, tp3003, 1, None),
        ("lattice_max", "5003-states", "5003 states T=60",
         lmax(lb5003[0], tp5003, c5003.penalty, l5003),
         lattice_max_bound(60, tp5003, l5003), 59, tp5003, 1, None),
        ("lattice_max", "long-words-5000-states", "20 words of 250 states T=150",
         lmax(lb_long, tp_long, c_long.penalty, 150),
         lattice_max_bound(150, tp_long, 150), 149, tp_long, 1, None),
        ("lattice_max", "8188-states", "8188 states T=30",
         lmax(lb8188, tp8188, c8188.penalty, 30),
         lattice_max_bound(30, tp8188, 30), 29, tp8188, 1, None),
        ("kbest", "main-nbest-clip-0-K8", f"phase 22's clip 0, T={len0}, K=8",
         kbest(lb_clip, tp_main, pc.penalty, 8),
         kbest_bound(len0, tp_main, 8), len0 - 1, tp_main, 1, 8),
        ("kbest", "flagship-K16", f"flagship T={t_total}, K=16",
         kbest(lb58[1], tp58, flag.penalty, 16, l58b),
         kbest_bound(t_total, tp58, 16), t_total - 1, tp58, 1, 16),
        ("kbest", "503-states-K8", f"503 states T={t_total}, K=8",
         kbest(lb503[1], tp503, c503.penalty, 8, l503b),
         kbest_bound(t_total, tp503, 8), t_total - 1, tp503, 1, 8),
        ("kbest", "5003-states-K16", "5003 states T=60, K=16",
         kbest(lb5003[0], tp5003, c5003.penalty, 16),
         kbest_bound(60, tp5003, 16), 59, tp5003, 1, 16),
    )
    for key, case, shape, fn, (b_ms, b_by), steps, tp, blocks, k in rows:
        s_k, n_x, n_e = tp.num_states, tp.exits.numel(), tp.entries.numel()
        plan = (tlk.kbest_plan(s_k, k, n_x) if key == "kbest"
                else tlk.lattice_sum_plan(s_k, n_x, n_e) if key == "lattice_sum"
                else tlk.lattice_max_plan(s_k, n_x, n_e))
        res = lattice_resources(key, s_k, plan)
        extra = {f"ptxas_{k_}": v for k_, v in res["team"].items()}
        turns = [device_ms(fn(simple), reps=5) for simple in (True, False, False, True)]
        ms, parent_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        # LSUM and LMAX: a (blocks, 2) grid, a row's forward and backward.
        floor_ms = lattice_skeleton_ms(dev, blocks, key != "kbest", plan["threads"],
                                       steps, 2 if key == "kbest" else 1, plan.get("ctas", 1))
        extra.update(branch=plan["branch"], bucket=plan.get("bucket", plan.get("pool")),
                     states_a_thread=plan.get("k"), threads=plan["threads"],
                     ctas=plan.get("ctas", 1),
                     ms_turns=json.dumps([turns[1], turns[2]]), parent_ms=parent_ms,
                     parent_turns=json.dumps([turns[0], turns[3]]),
                     parent_us_per_step=parent_ms / steps * 1e3,
                     slower_than_parent=min(turns[1:3]) > max(turns[0], turns[3]),
                     skeleton_us_per_step=floor_ms / steps * 1e3,
                     **{f"parent_ptxas_{k_}": v for k_, v in res["simple"].items()})
        log("timing", kernel=key, shape=shape, ms=ms, plain_ms=plain_ms[(key, case)],
            bound_ms=b_ms, bound_by=b_by, us_per_step=ms / steps * 1e3, **extra)
        if key not in timings:  # the first row of each kernel, the main path's, is its record
            timings[key] = (ms, plain_ms[(key, case)])
            yardsticks[key] = (None, b_ms, b_by)
    errs.update(err)
    log("phase", which="31 lattice", seconds=f"{time.perf_counter() - t_phase:.2f}")


def word_trellis_problem(gen, b, t, s, log_a=None, zero_length=False):
    """A banded word trellis input on the generator's device: log_b
    (B, T, S), log_a (B, S, S) per row (random, -inf sprinkled on the band)
    unless given, lengths with length-1 and (optionally) length-0 rows."""
    dev = gen.device
    if log_a is None:
        log_a = torch.log(torch.rand((b, s, s), generator=gen, device=dev))
        log_a[torch.rand((b, s, s), generator=gen, device=dev) < 0.05] = float("-inf")
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[1] = 1
    if zero_length:
        lengths[2::5] = 0
    return 2 * torch.randn((b, t, s), generator=gen, device=dev), log_a, lengths


def dtw_bound(h, n_frames, w):
    """bound() of one DTW column run: the (L, H) distances and the two flag
    rows read, end_rows read and the W costs written; per cell three mins,
    an add and a compare at PEAK_FP32_ALU."""
    return bound(4 * h * n_frames + 2 * h + 8 * w, [(5 * h * n_frames, PEAK_FP32_ALU)])


def slice4b_phases(dev, decode, pipe, launches, timings, errs, yardsticks):
    """Phases 23-26 (slice 4b): the banded word trellis on K3 and the
    isolated-word classifier; forced alignment, the legacy trainer and MAP
    adaptation; DTW and its column kernel; the MFCC precision tiers."""
    from cs304_tpu_torch.models import train_kmeans as tk
    from cs304_tpu_torch.models.adapt import map_adapt
    from cs304_tpu_torch.models.align import ForcedAligner
    from cs304_tpu_torch.models.collection import ModelCollection
    from cs304_tpu_torch.models.decoder import ContinuousDecoder
    from cs304_tpu_torch.models.hmm import (
        flagship_composite,
        flagship_models,
        uniform_forward_log_a,
    )
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig, ContinuousTrainer
    from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig
    from cs304_tpu_torch.ops import viterbi as vt
    from cs304_tpu_torch.ops.cuda import dtw as cdtw
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd
    from cs304_tpu_torch.ops.cuda import trellis_banded as tb
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.dtw import DTWRecognizer, dtw_columns_plain, pairwise_euclidean
    from cs304_tpu_torch.ops.gaussian import gaussian_log_pdf
    from cs304_tpu_torch.ops.mfcc import MFCCConfig, mfcc_batch, mfcc_features_batch
    from cs304_tpu_torch.ops.viterbi_assoc import viterbi_composite_assoc

    t_phase = time.perf_counter()
    k3 = (tb.banded_decode, tb.banded_forward, tsf.trellis_backtrace)

    def k3_counts():
        return {k.__name__: k.launches for k in k3}

    def k3_delta(before):
        return {k.__name__: k.launches - before[k.__name__] for k in k3}

    # -- 23. the banded word trellis on K3, and the isolated-word classifier --
    gen = torch.Generator(device=dev).manual_seed(23)
    boot = pipe["digit_feats"]
    km_cfg = SegmentalKMeansConfig(num_states=5, max_iterations=15, length_multiple=32)
    # The k-means boot's rows: 12 five-state models (phase 9's 11 digits and
    # a uniform one) x 64 utterances, a log_a a model.
    km_log_a = torch.as_tensor(np.stack(
        [pipe["models"][lab].log_a for lab in sorted(boot)] + [uniform_forward_log_a(5)]),
        device=dev)
    cases = {
        "kmeans-12x64": word_trellis_problem(
            gen, 12 * 64, 96, 5, km_log_a.repeat_interleave(64, dim=0)),
        "59-t1-length-0": word_trellis_problem(gen, 17, 1, 59, zero_length=True),
        "59-length-0": word_trellis_problem(gen, 64, 80, 59, zero_length=True),
        "s1": word_trellis_problem(gen, 9, 20, 1),
        "s2": word_trellis_problem(gen, 9, 20, 2, zero_length=True),
    }
    word_err = 0.0
    for name, (log_b, log_a, lengths) in cases.items():
        for quirk in (True, False):
            want_s, want_p = plain_run(vt.viterbi_banded_batch_plain, log_b, log_a, lengths,
                                       quirk)
            before = k3_counts()
            got_s, got_p = kernel_runs(
                ("trellis_banded_decode",) if quirk else
                ("trellis_banded_forward", "trellis_backtrace"),
                vt.viterbi_banded_batch, log_b, log_a, lengths, quirk)[0]
            torch.cuda.synchronize()
            rose = k3_delta(before)
            finite = torch.isfinite(want_s)
            same = {"scores": torch.equal(got_s, want_s),
                    "finite_paths": torch.equal(got_p[finite], want_p[finite])}
            b_k, t_k, s_k = log_b.shape
            reachable = t_k >= (s_k + 1) // 2
            log("word-trellis", case=name, quirk=quirk, B=b_k, T=t_k, S=s_k,
                finite_rows=int(finite.sum()), equal=json.dumps(same),
                launches=json.dumps(rose))
            if not all(same.values()):
                raise SystemExit(f"the word trellis on K3 disagrees with its plain "
                                 f"version ({name}, quirk={quirk})")
            if reachable and int(finite.sum()) < b_k // 3:
                raise SystemExit(f"word-trellis case {name} has too few finite rows")
            # One launch a call, the call made under each of the two poisons.
            if rose != ({"banded_decode": 2, "banded_forward": 0, "trellis_backtrace": 0}
                        if quirk else
                        {"banded_decode": 0, "banded_forward": 2, "trellis_backtrace": 2}):
                raise SystemExit(f"the word trellis launched {rose} ({name}, quirk={quirk})")

    # Phase 9's batched k-means boot through K3, beside the parent's plain
    # trellis (dense_forward on the card): wall time, a note, not a claim.
    def boot_run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tk.train_digit_models(boot, km_cfg, device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    before = k3_counts()
    boot_k3, sec_k3 = boot_run()
    boot_launches = k3_delta(before)
    tk.viterbi_banded_batch = vt.viterbi_banded_batch_plain
    try:
        boot_plain, sec_plain = boot_run()
    finally:
        tk.viterbi_banded_batch = vt.viterbi_banded_batch
    boot_same = all(np.array_equal(getattr(boot_k3[k], n), getattr(boot_plain[k], n))
                    for k in boot_k3 for n in ("means", "covariances", "log_a"))
    log("kmeans-boot", seconds_k3=f"{sec_k3:.3f}", seconds_plain_trellis=f"{sec_plain:.3f}",
        phase9_seconds_boot_with_silence=f"{pipe['seconds_boot']:.3f}",
        launches=json.dumps(boot_launches), models_equal=boot_same)
    if boot_launches["banded_decode"] == 0:
        raise SystemExit("the k-means boot never launched K3")

    # ModelCollection: the flagship's 11 digit models over phase 5's clips.
    digits = [m for m in flagship_models() if m.label != "S"]
    clips = decode["feat_list"]
    coll = ModelCollection.from_models(digits, device=dev)
    before = k3_counts()
    labels_card = coll.predict_batch(clips)
    torch.cuda.synchronize()
    coll_launches = k3_delta(before)
    scores_card = coll.score_batch(clips)
    coll_cpu = ModelCollection.from_models(digits, device="cpu")
    labels_cpu = coll_cpu.predict_batch(clips)
    scores_cpu = coll_cpu.score_batch(clips)
    score_err = float(np.max(np.abs(scores_card - scores_cpu)))
    coll_ms = window(lambda: [torch.as_tensor(coll.score_batch(clips))])
    log("collection", clips=len(clips), models=coll.num_models,
        k3_rows=len(clips) * coll.num_models, launches=json.dumps(coll_launches),
        labels_equal_cpu=labels_card == labels_cpu, max_abs_score_err=score_err,
        batch_ms=coll_ms, distinct_labels=len(set(labels_card)))
    if labels_card != labels_cpu or coll_launches["banded_decode"] != 1:
        raise SystemExit(f"ModelCollection on the card differs from the CPU port's or "
                         f"did not launch K3 once: {coll_launches}")

    # -- 24. alignment, the legacy trainer, MAP adaptation, the assoc decode --
    models = pipe["models"]
    aligner = {d: ForcedAligner(models, device=d) for d in (dev, "cpu")}
    n_rows = n_finite = 0
    align_err = 0.0
    before = k3_counts()
    for transcript, feats in pipe["pipe_labeled"].items():
        card = aligner[dev].align_batch(feats, transcript)
        cpu = aligner["cpu"].align_batch(feats, transcript)
        for a, c in zip(card, cpu):
            n_rows += 1
            if np.isfinite(a.score) != np.isfinite(c.score):
                raise SystemExit(f"ForcedAligner: finite on one side only ({transcript})")
            if not np.isfinite(c.score):
                continue
            n_finite += 1
            rel = abs(a.score - c.score) / max(1.0, abs(c.score))
            align_err = max(align_err, rel)
            if rel > 1e-4 or a.words != c.words:
                raise SystemExit(f"ForcedAligner on the card differs from the CPU port's "
                                 f"({transcript}: rel score err {rel})")
    align_launches = k3_delta(before)
    log("align", utterances=n_rows, finite=n_finite, max_rel_score_err=align_err,
        segments_equal=True, launches=json.dumps(align_launches))
    if align_launches["banded_decode"] != len(pipe["pipe_labeled"]) or n_finite < n_rows // 2:
        raise SystemExit(f"alignment launched {align_launches} or has too few finite rows")

    # One legacy (fused=False) iteration at train_bench's corpus, Viterbi and
    # Baum-Welch, against the fused iteration (tests/test_fused_training.py:
    # atol 2e-5 / rtol 1e-4; Baum-Welch atol 5e-5, as JAX holds its pair).
    for update, tol in (("viterbi", 2e-5), ("baum_welch", 5e-5)):
        trained, secs = {}, {}
        for fused in (True, False):
            cfg = ContinuousTrainConfig(max_iterations=1, silence_bootstrap=False,
                                        cov_reg=0.1, update=update, fused=fused)
            tr = ContinuousTrainer(dict(pipe["boot"]), cfg, device=dev)
            before = k3_counts()
            fbd_before = fbd.fb_dense.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train(pipe["labeled"])
            torch.cuda.synchronize()
            secs[fused] = time.perf_counter() - t0
            trained[fused] = (tr, {**k3_delta(before),
                                   "fb_dense": fbd.fb_dense.launches - fbd_before})
        worst, ok = 0.0, True
        for n in ("means_g", "covs_g", "log_a_g"):
            x, y = getattr(trained[False][0], n), getattr(trained[True][0], n)
            # Transition probabilities below float32's smallest normal: the
            # fused M-step divides in float32 (train_fused.py's
            # trans / row_sums), so such a probability is a subnormal with
            # fewer significant bits the smaller it is, or 0 (log -inf)
            # below the smallest subnormal; the legacy M-step divides in
            # float64 and keeps it. So -inf on one side passes only against
            # a probability float32 cannot hold (< 2^-149), and entries that
            # are finite and subnormal in BOTH trainers are left out of the
            # log-space comparison.
            is_a = n == "log_a_g"
            fx, fy = np.isfinite(x), np.isfinite(y)
            one_side = fx != fy
            under = one_side & (np.where(fx, x, y) < LOG_SUBNORMAL_MIN) & is_a
            ok &= not bool((one_side & ~under).any())
            sub_x, sub_y = (np.isfinite(v) & (v < LOG_FLT_MIN) for v in (x, y))
            sub = sub_x & sub_y & is_a
            fin = fx & fy & ~sub
            ok &= bool(np.allclose(x[fin], y[fin], atol=tol, rtol=1e-4))
            worst = max(worst, float(np.max(np.abs(x[fin] - y[fin]))))
        # The witness: how many subnormal transitions each trainer makes, how
        # far apart the left-out ones are, in log space and as probabilities
        # in units of float32's smallest subnormal (2^-149), and the largest
        # probability that is -inf on the other side, in the same units.
        p_x, p_y = (np.exp(v[sub].astype(np.float64)) for v in (x, y))
        p_under = np.exp(np.where(fx, x, y)[under].astype(np.float64))
        log("legacy-train", update=update, params_match_fused=ok, max_abs_diff=worst,
            subnormal_transitions_legacy=int(sub_x.sum()),
            subnormal_transitions_fused=int(sub_y.sum()), left_out=int(sub.sum()),
            left_out_max_abs_log_diff=float(np.max(np.abs(x[sub] - y[sub]), initial=0.0)),
            left_out_max_prob_diff_in_2e_149=float(
                np.max(np.abs(p_x - p_y), initial=0.0) / 2.0 ** -149),
            left_out_min_prob=float(np.min(np.minimum(p_x, p_y), initial=np.inf)),
            neg_inf_vs_finite=int(one_side.sum()),
            neg_inf_on_fused_side=int((under & fx).sum()),
            their_max_prob_in_2e_149=float(np.max(p_under, initial=0.0) / 2.0 ** -149),
            tol=f"atol {tol} rtol 1e-4", seconds_legacy=f"{secs[False]:.3f}",
            seconds_fused=f"{secs[True]:.3f}",
            launches_legacy=json.dumps(trained[False][1]))
        if not ok:
            raise SystemExit(f"one legacy {update} iteration differs from the fused one")
        if update == "viterbi" and trained[False][1]["banded_decode"] != len(pipe["labeled"]):
            raise SystemExit("the legacy Viterbi pass did not launch K3 once a transcript")
        # The legacy Baum-Welch pass: one FBD launch a transcript group.
        want_fbd = len(pipe["labeled"]) if update == "baum_welch" else 0
        if trained[False][1]["fb_dense"] != want_fbd or trained[True][1]["fb_dense"]:
            raise SystemExit(f"the legacy {update} pass launched FBD "
                             f"{trained[False][1]['fb_dense']} times for {want_fbd} "
                             f"transcripts (the fused one {trained[True][1]['fb_dense']})")

    off = np.zeros(39, np.float32)
    off[:13] = np.random.default_rng(24).normal(0, 0.8, 13)
    enroll = {tr: [f + off for f in feats[:3]]
              for tr, feats in list(pipe["pipe_labeled"].items())[:3]}
    adapted = {d: map_adapt(models, enroll, tau=10.0, device=d) for d in (dev, "cpu")}
    adapt_err = max(float(np.max(np.abs(adapted[dev][k].means - adapted["cpu"][k].means)))
                    for k in models)
    log("adapt", max_abs_mean_err=adapt_err,
        moved=not np.allclose(adapted[dev]["1"].means, models["1"].means))
    if adapt_err > 1e-4:
        raise SystemExit(f"map_adapt means on the card differ from the CPU port's: {adapt_err}")

    # The associative-scan decode against the sequential dense decode (the
    # flagship's topology and whitening emissions of 4 of phase 5's clips).
    flag = flagship_composite()
    params = flag.emission_params(dev)
    assoc_ok, assoc_err = True, 0.0
    for i in range(4):
        f = torch.as_tensor(clips[i], device=dev)
        log_b = gaussian_log_pdf(params, f)
        topo = (flag.log_a, flag.lower_of_state, flag.is_entry, flag.is_exit, flag.penalty)
        a_s, a_p = viterbi_composite_assoc(log_b, *topo)
        w_s, w_p = vt.viterbi_composite(log_b, *topo, quirk_backtrace=False)
        assoc_err = max(assoc_err, abs(float(a_s) - float(w_s)))
        assoc_ok &= bool(np.isclose(float(a_s), float(w_s), rtol=1e-4, atol=1e-3))
        assoc_ok &= bool(torch.equal(a_p, w_p))
    log("assoc", clips=4, T=len(clips[0]), S=flag.num_states, matches=assoc_ok,
        max_abs_score_err=assoc_err, tol="rtol 1e-4 atol 1e-3, paths equal")
    if not assoc_ok:
        raise SystemExit("viterbi_composite_assoc differs from the sequential decode")

    # -- 25. DTW: the column kernel and the recognizer ------------------------
    # Four takes of each digit as its templates (H ~ 1,100 rows), three
    # other takes of each as samples, and phase 9's longest sentence as a
    # long sample (L ~ 200).
    rng = np.random.default_rng(25)
    takes = 4
    templates = [boot[lab][k] for lab in sorted(boot) for k in range(takes)]
    samples = [(i, f) for i, lab in enumerate(sorted(boot))
               for f in boot[lab][takes:takes + 3]]
    rec = DTWRecognizer.from_features(templates, device=dev)
    h = int(sum(rec.word_lengths))
    dtw_err = 0.0

    def dtw_check(name, recog, dist_t, factor_list=(4.0, 0.3)):
        nonlocal dtw_err
        for pruning in (True, False):
            for factor in factor_list:
                flags = (recog._is_first, recog._is_second, recog._end_rows, pruning, factor)
                # And the recognizer's layout: rows 16 bytes apart, the pad
                # past H poisoned.
                got = kernel_runs("dtw", cdtw.dtw_columns, dist_t, *flags)[0]
                got_aligned = kernel_runs("dtw", lambda: cdtw.dtw_columns(
                    cdtw.aligned_rows(*dist_t.shape, dev).copy_(dist_t), *flags))[0]
                want = plain_run(dtw_columns_plain, dist_t, *flags)
                torch.cuda.synchronize()
                same = torch.equal(got, want) and torch.equal(got_aligned, want)
                fin = torch.isfinite(want)
                if fin.any():
                    dtw_err = max(dtw_err, float((got[fin] - want[fin]).abs().max()))
                log("DTW", case=name, L=dist_t.shape[0], H=dist_t.shape[1],
                    pruning=pruning, factor=factor, finite_words=int(fin.sum()),
                    bitwise=same)
                if not same:
                    raise SystemExit(f"the DTW kernel differs from its plain version ({name})")
                if factor == 4.0 and not fin.any():
                    raise SystemExit(f"DTW case {name} has no finite word")
        return got

    def random_words(n_words, lengths, integer=False):
        draw = ((lambda n: rng.integers(-3, 4, (n, 39)).astype(np.float32)) if integer
                else (lambda n: rng.normal(size=(n, 39)).astype(np.float32)))
        feats = [draw(int(n)) for n in np.broadcast_to(lengths, (n_words,))]
        return feats, DTWRecognizer.from_features(feats, device=dev)

    longest = max(samples, key=lambda x: len(x[1]))[1]
    dist_long = pairwise_euclidean(torch.as_tensor(longest, device=dev), rec._templates)
    dtw_check("digits", rec, dist_long)
    sentence = max((f for fs in pipe["pipe_labeled"].values() for f in fs), key=len)
    dist_sentence = pairwise_euclidean(torch.as_tensor(sentence, device=dev), rec._templates)
    dtw_check("sentence-sample", rec, dist_sentence)
    wide_sample = torch.as_tensor(rng.normal(size=(150, 39)).astype(np.float32), device=dev)
    # 2 to 16 runs of 4 rows a lane: the earlier kernel's 8,192-row cap and
    # past it; the unstaged tier of 64 rows a lane (past 16,384 rows) with
    # a ring of 3 and of 2 column slots (18,000 and 20,000 rows), and at the
    # cap (cdtw.MAX_TEMPLATE_ROWS = 32768: 16 warps, a one-column ring).
    wide = {}
    for n_words, word_len in ((20, 200), (32, 256), (40, 200), (60, 200), (90, 200),
                              (100, 200), (128, 256)):
        _feats, wide[n_words * word_len] = random_words(n_words, word_len)
        dist_wide = pairwise_euclidean(wide_sample, wide[n_words * word_len]._templates)
        dtw_check(f"{n_words * word_len}-rows", wide[n_words * word_len], dist_wide)
    # One-frame words (no second row), and L = 1 (only they can finish).
    one = DTWRecognizer.from_features(
        [templates[0][:1], templates[1], templates[takes][:1], templates[takes + 1]],
        device=dev)
    dist_one = pairwise_euclidean(torch.as_tensor(longest, device=dev), one._templates)
    dtw_check("one-frame-words", one, dist_one)
    dtw_check("L=1", one, dist_one[:1].contiguous())
    # Zero distances: integer features and word 2's own frames as the
    # sample, so its path costs exactly 0 and the prune threshold is a zero.
    zero_feats, zero = random_words(6, [30, 25, 40, 35, 28, 33], integer=True)
    got = dtw_check("zero-distance", zero, pairwise_euclidean(
        torch.as_tensor(zero_feats[2], device=dev), zero._templates))
    if float(got[2]) != 0.0:
        raise SystemExit("DTW zero-distance case: word 2 does not cost 0 on its own frames")

    # The main path: DTWRecognizer.search over the digit samples, counted.
    cdtw.dtw_columns.launches = 0
    found = [rec.search(f) for _i, f in samples]
    torch.cuda.synchronize()
    launches["dtw"] = cdtw.dtw_columns.launches
    rec_cpu = DTWRecognizer.from_features(templates, device="cpu")
    found_cpu = [rec_cpu.search(f) for _i, f in samples]
    same_idx = [a[0] for a in found] == [c[0] for c in found_cpu]
    acc = float(np.mean([a[0] // takes == i for a, (i, _f) in zip(found, samples)]))
    log("DTW", path="DTWRecognizer.search", samples=len(samples), H=h,
        L_max=max(len(f) for _i, f in samples), launches=launches["dtw"],
        same_words_as_cpu=same_idx, accuracy=acc)
    if not same_idx or launches["dtw"] != len(samples):
        raise SystemExit("DTWRecognizer.search on the card differs from the CPU port's")

    # The search past the earlier cap: 11 words x 10 templates of 80-100
    # frames; each sample a time-warped noisy copy of one template.
    big_feats, big = random_words(110, rng.integers(80, 101, 110))
    big_cpu = DTWRecognizer.from_features(big_feats, device="cpu")
    before = cdtw.dtw_columns.launches
    picks = list(range(0, 110, 10))
    warped = [np.repeat(big_feats[k], 2, axis=0)[::3] for k in picks]
    big_samples = [(w + rng.normal(0, 0.1, w.shape)).astype(np.float32) for w in warped]
    big_found = [big.search(f)[0] for f in big_samples]
    big_launches = cdtw.dtw_columns.launches - before
    big_cpu_found = [big_cpu.search(f)[0] for f in big_samples]
    log("DTW", path="DTWRecognizer.search", H=int(big._templates.shape[0]),
        samples=len(big_samples), launches=big_launches, words=big_found,
        same_words_as_cpu=big_found == big_cpu_found, found_own=big_found == picks)
    if big_found != big_cpu_found or big_launches != len(big_samples):
        raise SystemExit("DTWRecognizer.search past 8,192 rows differs from the CPU port's")

    # A search's host wall split (digit samples): the sample's upload, the
    # distances, the kernel, the readback, each ended by a synchronize.
    from cs304_tpu_torch.device import upload

    split = {"upload": [], "distances": [], "kernel": [], "readback": [], "search": []}
    for _rep in range(3):
        for _i, f in samples:
            t0 = time.perf_counter()
            x = upload(np.asarray(f, np.float32), dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dist_t = pairwise_euclidean(x, rec._templates, rec._templates_sq,
                                        out=cdtw.aligned_rows(x.shape[0], h, dev))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out = cdtw.dtw_columns(dist_t, rec._is_first, rec._is_second, rec._end_rows)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            out.cpu().numpy()
            t4 = time.perf_counter()
            rec.search(f)
            t5 = time.perf_counter()
            for key, dt_s in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                split[key].append(dt_s * 1e3)
    log("DTW", host_split_ms={k: float(np.median(v)) for k, v in split.items()},
        samples=len(samples), reps=3, statistic="median ms a search",
        note="stages each end in a synchronize; search is rec.search as a user calls it")

    # Timed on rows 16 bytes apart, as DTWRecognizer.distances writes them
    # (a contiguous (L, 1134) is re-laid by the wrapper first, a copy the
    # search does not make).
    def aligned(dist_t):
        return cdtw.aligned_rows(*dist_t.shape, dev).copy_(dist_t)

    args = (aligned(dist_long), rec._is_first, rec._is_second, rec._end_rows)
    timings["dtw"] = (device_ms(lambda: cdtw.dtw_columns(*args)),
                      cuda_ms(lambda: dtw_columns_plain(*args), reps=3))
    yardsticks["dtw"] = (None, *dtw_bound(h, dist_long.shape[0], len(templates)))
    errs["dtw"] = dtw_err
    # The serial floor a column is a recorded constant, not measured here:
    # the bare column skeleton (a barrier, a warp reduction, the
    # shared-memory exchange) of the earlier design, timed on an NVIDIA H100
    # 80GB HBM3 at 700.00 W (PERF.md section 6, the DTW redesign's step 0).
    floors = {"digits": 0.180, "sentence-sample": 0.140, "8000-rows": 0.207}
    log("DTW", recorded_serial_floor_us_per_column=floors,
        card="NVIDIA H100 80GB HBM3, 700.00 W", source="PERF.md section 6",
        note="a constant beside this run's us_per_column, not measured in this run")
    for name, recog, dist_t in (("digits", rec, dist_long),
                                ("sentence-sample", rec, dist_sentence),
                                ("8000-rows", wide[8000], pairwise_euclidean(
                                    wide_sample, wide[8000]._templates)),
                                ("32768-rows", wide[32768], pairwise_euclidean(
                                    wide_sample, wide[32768]._templates))):
        n_cols, n_rows = dist_t.shape
        rows = aligned(dist_t)
        ms = (timings["dtw"][0] if name == "digits" else
              device_ms(lambda: cdtw.dtw_columns(rows, recog._is_first, recog._is_second,
                                                 recog._end_rows)))
        b_ms, b_by = dtw_bound(n_rows, n_cols, len(recog.word_lengths))
        log("timing", kernel="dtw", shape=f"H={n_rows} L={n_cols}", case=name, ms=ms,
            bound_ms=b_ms, bound_by=b_by, us_per_column=ms / n_cols * 1e3,
            recorded_serial_floor_us_per_column=floors.get(name, "none recorded"),
            **({"plain_ms": timings["dtw"][1]} if name == "digits" else {}))

    # -- 26. the MFCC precision tiers -----------------------------------------
    # "high" is bf16_3x; "default", as in the JAX package, the float32 product
    # of "highest".
    sig, ns = decode["sig_dev"], decode["ns_dev"]
    feats = {}
    for tier in ("highest", "high", "default"):
        cfg = MFCCConfig(precision=tier)
        feats[tier], n_frames = mfcc_features_batch(sig, ns, cfg)
        ms = cuda_ms(lambda: mfcc_features_batch(sig, ns, cfg), reps=5)
        log("mfcc-tier", tier=tier, ms=ms)
    high_err = float((feats["high"] - feats["highest"]).abs().max())
    default_same = torch.equal(feats["default"], feats["highest"])
    log("mfcc-tier", B=sig.shape[0], max_abs_high=high_err, default_equals_highest=default_same,
        bounds="high max <= 1e-2 (tests/test_torch_mfcc_tiers.py); default bitwise highest")
    if not (0 < high_err <= 1e-2 and default_same):
        raise SystemExit("an MFCC tier is outside its stated bound of 'highest'")
    # Transcripts: the flagship decode on phase 5's clips, and phase 9's
    # models on its evaluation clips (accuracy), "high" against "highest".
    nf = n_frames.tolist()
    flag_dec = decode["dec"]
    tiers = ("highest", "high")
    texts = {t: flag_dec.predict_batch([f[:n].cpu().numpy() for f, n in zip(feats[t], nf)])
             for t in tiers}
    pipe_dec = ContinuousDecoder(models, penalty=-100.0, device=dev)
    truths = pipe["eval"]["train_speakers"][0]
    # Phase 9's evaluation clips again, through each tier's front end.
    eval_clips = [pipe["corpus"].sentence_audio(tr, spk, jitter_seed=33)
                  for tr in PIPELINE_TRANSCRIPTS for spk in range(6)]
    eval_texts = {t: pipe_dec.predict_batch(mfcc_batch(eval_clips, cfg=MFCCConfig(precision=t),
                                                       device=dev)) for t in tiers}
    agree = (float(np.mean([a == b for a, b in zip(texts["high"], texts["highest"])])),
             float(np.mean([a == b for a, b in zip(eval_texts["high"],
                                                   eval_texts["highest"])])))
    accuracy = {t: float(np.mean([p == q for p, q in zip(eval_texts[t], truths)]))
                for t in tiers}
    log("mfcc-tier", high_agreement_with_highest=json.dumps(agree),
        phase9_accuracy=json.dumps(accuracy), clips=len(texts["highest"]),
        eval_clips=len(eval_clips))
    if agree != (1.0, 1.0):
        raise SystemExit(f"'high' MFCC transcripts differ from 'highest': {agree}")
    log("phase", which="23-26 slice 4b", seconds=f"{time.perf_counter() - t_phase:.2f}")


# Phase 27: benchmarks/phone_tier.py's default configuration with every tier
# on (--biphones --triphones --senones 4 --tie-triphones 4), and its gates
# (phone_tier.py:472-478).
PHONE_TIER = SimpleNamespace(
    num_words=30, oov_words=3, phones_per_word=(3, 5), num_phones=24, train_speakers=4,
    test_speakers=2,
    takes=3, train_sentences=12, eval_sentences=10, iterations=10, cov_reg=0.1,
    penalty=-100.0, seed=5, senones=4, senone_min_gain=0.0, senone_min_count=8.0,
    tie_triphones=4, gmm_iterations=4, agree_clips=8)
PHONE_GATE, OOV_GATE = 0.85, 0.3  # the context-dependent tiers share PHONE_GATE


def check_launches(what, rose, need):
    """Fail unless every counter named in need rose (what names the phase
    and the run)."""
    missing = [k for k in need if rose[k] == 0]
    if missing:
        raise SystemExit(f"{what} never launched {missing}: {rose}")


def phone_tier_phase(dev, card, cfg=PHONE_TIER):
    """Phase 27: benchmarks/phone_tier.py's flow with the port's modules,
    every tier trained and decoded on the card; its accuracy gates, card
    transcripts against the CPU port's, senone ties and determinism, and the
    launches of K3 (training) and K1 / K2 (decoding) in every tier. Every
    plain trellis (and the plain emission) is guarded: a call on a CUDA
    tensor fails the phase.

    Training is held against the plain path too: the last fused
    iteration's K3 launch of the phone tier and of the (tied) senone tier
    bitwise the plain trellis on CPU copies of its inputs, and the phone
    tier trained once more on the CPU from the same boot and features,
    within the CPU tests' rtol 1e-4 / atol 1e-5. One tied iteration and
    its pooling are timed.

    Each tier decodes twice: with the decoder's default
    emissions="whiten", as phone_tier.py decodes (no emission kernel: the
    whitening is one matmul), and with emissions="quad", which runs K1.
    The gates and the CPU agreement hold for both."""
    from cs304_tpu_torch.audio.endpointing import SignalSeparation
    from cs304_tpu_torch.data.wordvocab import make_lexicon, make_word_corpus
    from cs304_tpu_torch.models import decoder as dm
    from cs304_tpu_torch.models import train_fused as tf
    from cs304_tpu_torch.models.biphone import compose_word_models_biphone, train_biphone_models
    from cs304_tpu_torch.models.lexicon import (
        compose_word_models,
        train_phone_models,
        uniform_phone_boot,
    )
    from cs304_tpu_torch.models.senone import (
        compose_word_models_senone,
        senone_table,
        senone_unit_table,
        train_senone_models,
    )
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig, ContinuousTrainer
    from cs304_tpu_torch.models.train_kmeans import (
        SegmentalKMeansConfig,
        train_digit_models,
        train_word_hmm,
    )
    from cs304_tpu_torch.models.triphone import (
        compose_word_models_triphone,
        tie_and_train_triphones,
        train_triphone_models,
    )
    from cs304_tpu_torch.ops import viterbi as vt
    from cs304_tpu_torch.ops.cuda import emission as em
    from cs304_tpu_torch.ops.cuda import trellis_banded as tb
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.mfcc import mfcc_batch
    from cs304_tpu_torch.reporting.metrics import corpus_wer

    t_phase = time.perf_counter()
    counters = {"K3": tb.banded_decode, "K3-bp": tb.banded_forward, "K1": em.emission,
                "K1-split": em.emission_split, "K2": tsf.scanfree_decode}

    def counts():
        torch.cuda.synchronize()
        return {k: c.launches for k, c in counters.items()}

    def delta(before):
        now = counts()
        return {k: now[k] - before[k] for k in counters}

    plain_on_card = {}

    recorded = {}

    def record(mod, name):
        """Keep the arguments and result of the last mod.name call; the
        call itself is unchanged (no extra launch)."""
        fn = getattr(mod, name)

        def kept(*args, **kwargs):
            out = fn(*args, **kwargs)
            recorded[name] = (args, kwargs, out)
            return out
        setattr(mod, name, kept)
        return mod, name, fn

    def k3_against_plain(tier):
        """The tier's last fused-iteration K3 launch (its own inputs and
        output) against the plain trellis, _banded_trellis_final, on CPU
        copies of the same inputs: scores and paths bitwise."""
        args, _, (scores, paths) = recorded.pop("banded_decode")
        if args[0].device != scores.device or scores.device.type != dev.type:
            raise SystemExit(f"phase 27: the {tier} tier's trellis did not run on {dev}")
        want_s, want_p = tf._banded_trellis_final(*(a.cpu() for a in args))
        same = {"scores": torch.equal(scores.cpu(), want_s),
                "paths": torch.equal(paths.cpu(), want_p)}
        b, t, s = args[0].shape
        log("phone-tier", stage="K3-vs-plain", tier=tier, B=b, T=t, S_sent=s,
            utterances=int((args[4] > 0).sum()), equal=json.dumps(same))
        if not all(same.values()):
            raise SystemExit(f"phase 27: K3 differs from the plain trellis on the {tier} "
                             f"tier's training batch: {same}")

    saved = [guard(plain_on_card, m, n) for m, n in (
        (tb, "banded_sentence_forward"), (tb, "backtrace_batch"),
        (vt, "viterbi_banded_batch_plain"), (tf, "_banded_trellis_final"),
        (tsf, "_plain_search"), (tsf, "forward_fast"), (dm, "viterbi_composite_batch_fast"),
        (em, "emission_plain"))]
    saved += [record(tf, "banded_decode"), record(tf, "fused_train_run")]
    try:
        # -- the corpus, the boots and the training sentences (phone_tier.py) --
        t0 = time.perf_counter()
        corpus = make_word_corpus(cfg.num_words, num_train_speakers=cfg.train_speakers,
                                  num_test_speakers=cfg.test_speakers, takes_per_digit=cfg.takes,
                                  phones_per_word=cfg.phones_per_word,
                                  num_phones=cfg.num_phones)
        lex = make_lexicon(cfg.num_words, phones_per_word=cfg.phones_per_word,
                           num_phones=cfg.num_phones)
        labels = corpus.labels
        oov = labels[-cfg.oov_words:]
        train_words = [w for w in labels if w not in oov]
        covered = {p for w in oov for p in lex[w]} <= {p for w in train_words for p in lex[w]}
        sep = SignalSeparation()
        stripped = {w: mfcc_batch(sep.remove_empty_batch(corpus.train_dataset[w]), device=dev)
                    for w in train_words}
        raw = {w: mfcc_batch(corpus.train_dataset[w], device=dev) for w in train_words}
        noises = [x for x in sep.get_all_noises() if len(x) >= 9 * sep.frame_size]
        before = counts()
        silence = train_word_hmm("S", mfcc_batch(noises, device=dev), SegmentalKMeansConfig(
            num_states=3, max_iterations=12, length_multiple=32), device=dev).model
        check_launches("phase 27: the silence model's k-means", delta(before), ["K3"])
        rng = np.random.default_rng(cfg.seed)
        sentences, seen = [], set()
        while len(sentences) < cfg.train_sentences:
            tr = tuple(str(x) for x in rng.choice(train_words, size=3))
            if tr not in seen:
                seen.add(tr)
                sentences.append(tr)
        labeled = {(w,): raw[w] for w in train_words}
        labeled.update({tr: mfcc_batch([corpus.sentence_audio(tr, spk, jitter_seed=cfg.seed * 1000)
                                        for spk in range(cfg.train_speakers)], device=dev)
                        for tr in sentences})
        # The held-out speakers' sentences, in-vocabulary and with OOV words,
        # drawn on from the same generator as phone_tier.py draws them.
        test_speakers = range(cfg.train_speakers, cfg.train_speakers + cfg.test_speakers)
        truths, clips, k = [], [], 0
        while len(truths) < cfg.eval_sentences * cfg.test_speakers:
            tr = tuple(str(x) for x in rng.choice(train_words, size=3))
            for spk in test_speakers:
                truths.append("".join(tr))
                clips.append(corpus.sentence_audio(tr, spk, jitter_seed=cfg.seed * 1000 + 200 + k))
            k += 1
        oov_truths, oov_clips = [], []
        for k in range(cfg.eval_sentences):
            tr = (str(rng.choice(oov)), str(rng.choice(train_words)), str(rng.choice(oov)))
            for spk in test_speakers:
                oov_truths.append("".join(tr))
                oov_clips.append(corpus.sentence_audio(tr, spk,
                                                       jitter_seed=cfg.seed * 1000 + 300 + k))
        feats, oov_feats = mfcc_batch(clips, device=dev), mfcc_batch(oov_clips, device=dev)
        log("phone-tier", stage="setup", words=len(train_words), oov=json.dumps(oov),
            phones=len(lex.phones), oov_phones_covered=covered, train_utterances=sum(
                len(v) for v in labeled.values()), transcripts=len(labeled),
            eval_clips=len(feats), oov_clips=len(oov_feats),
            seconds=f"{time.perf_counter() - t0:.2f}", card=card)

        train_cfg = ContinuousTrainConfig(max_iterations=cfg.iterations, cov_reg=cfg.cov_reg)
        tiers, stats = {}, {}

        def timed_train(name, fn):
            before = counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stats[name] = {"train_s": time.perf_counter() - t0, "train_launches": delta(before)}
            check_launches(f"phase 27: the {name} tier's training", stats[name]["train_launches"], ["K3"])
            return out

        def params_of(models):
            return int(sum(m.means.size + m.covariances.size + np.isfinite(m.log_a).sum()
                           for m in models.values()))

        # -- training, every tier on the card --------------------------------
        def word_tier():
            models = train_digit_models(stripped, SegmentalKMeansConfig(
                num_states=5, max_iterations=12, length_multiple=32), device=dev)
            models["S"] = silence
            tr = ContinuousTrainer(models, train_cfg, device=dev)
            n = tr.train(labeled)
            return tr.models(), n

        tiers["word"], it = timed_train("word", word_tier)
        stats["word"].update(iterations=it, params=params_of(tiers["word"]))

        phone_boot = uniform_phone_boot(stripped, lex)
        phone_boot["S"] = silence
        phones, it = timed_train("phone", lambda: train_phone_models(
            phone_boot, labeled, lex, train_cfg, device=dev))
        stats["phone"].update(iterations=it, params=params_of(phones))
        k3_against_plain("phone")
        # The phone tier once more on the CPU: the same boot and features.
        t0 = time.perf_counter()
        phones_cpu, it_cpu = train_phone_models(phone_boot, labeled, lex, train_cfg,
                                                device="cpu")
        cpu_s = time.perf_counter() - t0
        recorded.pop("banded_decode", None)
        worst, close = 0.0, it_cpu == it and sorted(phones_cpu) == sorted(phones)
        for p in phones:
            for n in ("means", "covariances", "log_a"):
                got, want = getattr(phones[p], n), getattr(phones_cpu[p], n)
                fin = np.isfinite(want)
                close &= bool(np.array_equal(np.isfinite(got), fin) and np.allclose(
                    got[fin], want[fin], rtol=1e-4, atol=1e-5))
                err = np.abs(got[fin] - want[fin]) / (1e-5 + 1e-4 * np.abs(want[fin]))
                worst = max(worst, float(err.max(initial=0.0)))
        log("phone-tier", stage="card-vs-cpu-training", tier="phone", iterations=it,
            cpu_iterations=it_cpu, params_within_tolerance=close, tolerance="rtol 1e-4 atol 1e-5",
            worst_share_of_tolerance=worst, cpu_train_s=f"{cpu_s:.3f}")
        if not close:
            raise SystemExit("phase 27: the phone tier trained on the card is not within "
                             "rtol 1e-4 / atol 1e-5 of its CPU training")
        tiers["phone"] = compose_word_models(lex, phones)
        bi, it = timed_train("biphone", lambda: train_biphone_models(
            phones, labeled, lex, train_cfg, device=dev))
        stats["biphone"].update(iterations=it, params=params_of(bi), units=len(bi) - 1)
        tiers["biphone"] = compose_word_models_biphone(lex, bi, phones)
        tri, it = timed_train("triphone", lambda: train_triphone_models(
            phones, labeled, lex, train_cfg, device=dev))
        stats["triphone"].update(iterations=it, params=params_of(tri), units=len(tri) - 1)
        tiers["triphone"] = compose_word_models_triphone(lex, tri, phones, biphone_models=bi)
        tied, tied_lex, mapping = timed_train("tied_triphone", lambda: tie_and_train_triphones(
            phones, labeled, lex, max_per_phone=cfg.tie_triphones, config=train_cfg, device=dev))
        reachable = {lab for seq in tied_lex.entries.values() for lab in seq}
        stats["tied_triphone"].update(params=params_of({lab: tied[lab] for lab in reachable}),
                                      clusters=len(set(mapping.values())))
        tiers["tied_triphone"] = compose_word_models(tied_lex, tied)

        def senone_tier():
            return train_senone_models(phones, labeled, lex, max_per_state=cfg.senones,
                                       min_gain=cfg.senone_min_gain,
                                       min_count=cfg.senone_min_count, config=train_cfg,
                                       device=dev)

        sen, tying, it = timed_train("senone", senone_tier)
        k3_against_plain("senone")
        run_args, run_kwargs, _ = recorded.pop("fused_train_run")
        plan = run_kwargs["tie_flat"]
        if plan is None or run_kwargs["trans_tie"] is None:
            raise SystemExit("phase 27: the senone tier trained without ties")
        # One tied fused iteration, and the pooling alone on the m2 shape.
        iteration = {k: v for k, v in run_kwargs.items()
                     if k not in ("max_iterations", "update")}

        def one_iteration(**over):
            return lambda: tf.fused_viterbi_iteration(*run_args, **{**iteration, **over})

        f_rows, dim = plan.group_of.numel(), run_args[0].shape[-1]
        m2 = torch.randn((f_rows, dim, dim), device=dev)
        pool_ms = cuda_ms(lambda: tf._pool_slots(m2, plan))
        index_add_ms = cuda_ms(lambda: torch.zeros_like(m2).index_add_(
            0, plan.group_of, m2)[plan.group_of])
        tied_ms = cuda_ms(one_iteration(), reps=10)
        untied_ms = cuda_ms(one_iteration(tie_flat=None, trans_tie=None, conv_tie=None),
                            reps=10)
        log("phone-tier", stage="tie-pooling", rows=f_rows, groups=len(plan.members[0]),
            largest_group=len(plan.members), rows_gathered=sum(len(m) for m in plan.members),
            pool_m2_ms=pool_ms, index_add_m2_ms=index_add_ms, tied_iteration_ms=tied_ms,
            untied_iteration_ms=untied_ms, card=card)
        sen_params = senone_table(sen, tying)
        d = next(iter(sen.values())).dim
        stats["senone"].update(iterations=it, units=len(sen) - 1, senones=tying.num_senones(),
                               params=int(len(sen_params) * (d + d * d) + sum(
                                   np.isfinite(phones[p].log_a).sum() for p in lex.phones)))
        tiers["senone"] = compose_word_models_senone(lex, sen, tying, phones)
        tiers["senone_synthesis"] = compose_word_models_senone(lex, sen, tying, phones,
                                                               unseen="synthesize")
        _, n_synth = senone_unit_table(lex, sen, tying, phones, unseen="synthesize")

        # Tied slots are bitwise shared across units, and tied transitions.
        owners = {}
        for key, name in tying.senone_of.items():
            unit, st = key.rsplit("/", 1)
            owners.setdefault(name, []).append((unit, int(st)))
        shared_groups = [o for o in owners.values() if len(o) > 1]
        ties_ok = all(np.array_equal(sen[u].means[s], sen[u0].means[s0])
                      and np.array_equal(sen[u].covariances[s], sen[u0].covariances[s0])
                      for (u0, s0), *rest in shared_groups for u, s in rest)
        by_phone = {}
        for unit in sen:
            if unit != "S":
                by_phone.setdefault(unit.split("-")[1].split("+")[0], []).append(unit)
        ties_ok &= all(np.array_equal(sen[u].log_a, sen[us[0]].log_a)
                       for us in by_phone.values() for u in us[1:])
        # A second senone training on the card: bitwise the first.
        sen2, tying2, it2 = senone_tier()
        same = (it2 == it and tying2.senone_of == tying.senone_of and sorted(sen2) == sorted(sen)
                and all(np.array_equal(getattr(sen[u], n), getattr(sen2[u], n))
                        for u in sen for n in ("means", "covariances", "log_a")))
        log("phone-tier", stage="senone-ties", shared_senones=len(shared_groups),
            shared_slots=sum(len(o) for o in shared_groups), ties_bitwise=ties_ok,
            second_training_bitwise=same, senones=tying.num_senones(), card=card)
        if not shared_groups or not ties_ok or not same:
            raise SystemExit("phase 27: senone ties not bitwise shared, or a second senone "
                             "training on the card differs from the first")

        # A K=2 GMM phone tier (train_phone_models' gmm_mixtures stage).
        def gmm_tier():
            boot = uniform_phone_boot(stripped, lex)
            boot["S"] = silence
            return train_phone_models(boot, labeled, lex, ContinuousTrainConfig(
                max_iterations=cfg.gmm_iterations, cov_reg=cfg.cov_reg), gmm_mixtures=2,
                device=dev)

        gmm_phones, it = timed_train("phone_gmm2", gmm_tier)
        stats["phone_gmm2"].update(iterations=it, params=int(sum(
            m.means.size + m.covariances.size + m.weights.size + np.isfinite(m.log_a).sum()
            for m in gmm_phones.values())))
        tiers["phone_gmm2"] = compose_word_models(lex, gmm_phones)

        # -- decoding on the card: in-vocab, OOV, and the CPU port's agreement,
        # with the default emissions (phone_tier.py's) and with K1's --------
        n_agree = cfg.agree_clips
        accs, oov_accs, agreement = {}, {}, {}
        phone_oov_wer = None
        for name, models in tiers.items():
            for form, kernels in (("whiten", ["K2"]), ("quad", ["K1", "K2"])):
                key = (name, form)
                dec = dm.ContinuousDecoder(models, penalty=cfg.penalty, emissions=form,
                                           device=dev)
                before = counts()
                preds = dec.predict_batch(feats)
                oov_preds = dec.predict_batch(oov_feats)
                rose = delta(before)
                check_launches(f"phase 27: the {name} tier's {form} decode", rose, kernels)
                torch.cuda.synchronize()
                best = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    dec.predict_batch(feats)
                    best = min(best, time.perf_counter() - t0)
                cpu = dm.ContinuousDecoder(models, penalty=cfg.penalty, emissions=form,
                                           device="cpu")
                cpu_preds = cpu.predict_batch(feats[:n_agree] + oov_feats[:n_agree])
                agreement[key] = float(np.mean([a == b for a, b in zip(
                    preds[:n_agree] + oov_preds[:n_agree], cpu_preds)]))
                accs[key] = float(np.mean([p == t for p, t in zip(preds, truths)]))
                oov_accs[key] = float(np.mean([p == t for p, t in zip(oov_preds, oov_truths)]))
                if key == ("phone", "whiten"):
                    phone_oov_wer = corpus_wer([
                        ([t[i:i + 3] for i in range(0, len(t), 3)],
                         [p[i:i + 3] for i in range(0, len(p), 3)])
                        for t, p in zip(oov_truths, oov_preds)])["wer"]
                st = stats.get(name, {})
                log("phone-tier", tier=name, emissions=form,
                    train_s=f"{st.get('train_s', 0.0):.3f}",
                    iterations=st.get("iterations"), params=st.get("params"),
                    composite_states=dec.composite.num_states,
                    decode_ms_a_batch=f"{best * 1e3:.2f}", batch=len(feats),
                    in_vocab_acc=accs[key],
                    oov_acc=oov_accs[key] if name != "word" else "n/a",
                    cpu_agreement=agreement[key], agree_clips=2 * n_agree,
                    train_launches=json.dumps(st.get("train_launches")),
                    decode_launches=json.dumps(rose),
                    **{k: st[k] for k in ("units", "clusters", "senones") if k in st},
                    card=card)
        log("phone-tier", stage="oov", phone_tier_oov_exact=oov_accs["phone", "whiten"],
            phone_tier_oov_wer=phone_oov_wer, senone_synthesized_units=n_synth,
            senone_tier_oov_exact_tree_synthesis=oov_accs["senone_synthesis", "whiten"],
            plain_on_card=json.dumps(plain_on_card), card=card)
        gates = {}
        for form in ("whiten", "quad"):
            gates[f"phone_tier/{form}"] = accs["phone", form] >= PHONE_GATE
            gates[f"oov/{form}"] = oov_accs["phone", form] >= OOV_GATE
            gates.update({f"{t}_tier/{form}": accs[t, form] >= PHONE_GATE
                          for t in ("biphone", "triphone", "tied_triphone", "senone")})
        log("phone-tier", gates=json.dumps(gates), bars=f"in-vocab >= {PHONE_GATE}, "
            f"phone OOV exact >= {OOV_GATE} (benchmarks/phone_tier.py:472-478)")
        if not all(gates.values()):
            raise SystemExit(f"phase 27: a phone_tier.py gate failed: {gates}")
        if any(a != 1.0 for a in agreement.values()):
            raise SystemExit(f"phase 27: card transcripts differ from the CPU port's: "
                             f"{ {'/'.join(k): a for k, a in agreement.items()} }")
        if plain_on_card:
            raise SystemExit(f"phase 27: a plain version ran on the card: {plain_on_card}")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    log("phase", which="27 phone tiers", seconds=f"{time.perf_counter() - t_phase:.2f}",
        card=card)


# Phase 28: WAVs of 3-digit sentences by the synthetic corpus's test speakers
# (6 and 7 of 6 + 2): (transcript, speaker, jitter seed).
CLI_SENTENCES = (("375", 6, 3), ("9O2", 7, 4), ("186", 6, 5), ("4Z8", 7, 6))
CLI_ACC_BAR = 0.9  # tests/test_cli_chain.py:106, the n-digit CSVs
CLI_BUDGET_S = 60.0  # what phase 28 may add to the script's run
CLI_KMEANS = ["--set", "train.max_iterations=6", "--set", "train.length_multiple=32"]
CLI_EMBEDDED = ["--set", "continuous.max_iterations=3", "--set", "continuous.cov_reg=0.1"]
CLI_GMM_ONE_ITERATION = ["--set", "train.max_iterations=1", "--set", "train.length_multiple=32"]


def transcripts_of(out):
    """transcribe's printed lines -> [(wav, transcript)]."""
    return [tuple(line.split("  [")[0].rsplit(": ", 1)) for line in out.strip().splitlines()
            if ".wav: " in line]


def cli_phase(dev, card):
    """Phase 28: the README's Quickstart chain through the port's scripts,
    each script's main(argv) called in this process on the synthetic
    corpus, with tests/test_cli_chain.py's tiny settings: project3_train
    (and project3_predict and project5_find_trans_penalty where matplotlib
    is installed), project5_train_no_empty, project6_train (Viterbi with
    --state-dir, Baum-Welch, --gmm-mixtures 2), project5_test_ndigits
    (--csv-out, --bigram-lm), transcribe on WAVs of 3-digit test-speaker
    sentences (plain, --fast, --confidence --timings, --beam 50,
    --known-count 3, --grammar-strings, --min-duration 2, and plain and
    each constrained one again with --device cpu), align, adapt_speaker, project6_interactive --wav with
    n-best, confidences, a keyword and a lattice, train_phones at its
    default 30 words with 3 iterations, demo_serving. The card runs pass no
    --device (the default is the card).

    Gates: every script returns; the n-digit CSVs' accuracy >= 0.9 on both
    splits; align gives 3 7 5 with increasing frames; transcribe's
    transcripts equal ContinuousDecoder(device=card).predict_batch on the
    same checkpoint and per-file features; project6_train's Viterbi
    parameters bitwise a direct ContinuousTrainer run on the card; each
    --device cpu transcribe (plain, counted, grammar, duration) equal to
    the card's and neither launching a card kernel nor allocating card
    memory; each script launched the
    kernels its path runs (the counted and grammar decodes the PLANES
    kernel, the duration decode the DURATION kernel, --confidence LSUM,
    project6_interactive's n-best KBEST and its keyword and forward lattice
    LMAX and LSUM); no
    plain trellis (the constrained ones included), emission,
    forward-backward or pool step on a CUDA tensor; the phase within
    CLI_BUDGET_S. One [cli] line a script: wall seconds and launches."""
    import importlib
    import importlib.util
    import os
    import shutil
    import tempfile
    from dataclasses import replace

    from cs304_tpu_torch.audio.wav import read_wav, write_wav_int16
    from cs304_tpu_torch.data.synthetic import SyntheticTIDigits
    from cs304_tpu_torch.data.ti_digits import DIGIT_LABELS
    from cs304_tpu_torch.models import decoder as dm
    from cs304_tpu_torch.models import train_fused as tf
    from cs304_tpu_torch.models.collection import ModelCollection
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig, ContinuousTrainer
    from cs304_tpu_torch.ops import grammar as gm
    from cs304_tpu_torch.ops import streaming_batch as sb
    from cs304_tpu_torch.ops import viterbi as vt
    from cs304_tpu_torch.ops import viterbi_counted as tvc
    from cs304_tpu_torch.ops import viterbi_duration as tvd
    from cs304_tpu_torch.ops.cuda import emission as em
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd
    from cs304_tpu_torch.ops.cuda import trellis_banded as tb
    from cs304_tpu_torch.ops.cuda import trellis_constrained as tcs
    from cs304_tpu_torch.ops.cuda import trellis_dense as tdn
    from cs304_tpu_torch.ops.cuda import trellis_fb as tfb
    from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.cuda import trellis_stream as tst
    from cs304_tpu_torch.ops.mfcc import mfcc_batch
    from cs304_tpu_torch.reporting.csvnia import CSVReader
    from cs304_tpu_torch.scripts._common import run_in_process
    from cs304_tpu_torch.utils.checkpoint import load_models
    from cs304_tpu_torch.utils.config import Config

    t_phase = time.perf_counter()
    counters = {"K3": tb.banded_decode, "K3-bp": tb.banded_forward,
                "K2": tsf.scanfree_decode, "K2-lm": tsf.scanfree_decode_lm,
                "K2-beam": tsf.scanfree_decode_beam, "K2-fwd": tsf.trellis_forward,
                "K2-bt": tsf.trellis_backtrace, "K1": em.emission, "K1-split": em.emission_split,
                "K4": tdn.trellis_dense_forward, "E-step": tfb.banded_fb_posteriors,
                "FB": tfb.banded_fb, "STREAM": tst.stream_advance,
                "PLANES": tcs.planes_decode, "DURATION": tcs.duration_decode,
                "LSUM": tlk.lattice_sum_passes, "LMAX": tlk.lattice_max_passes,
                "KBEST": tlk.kbest_forward, "FBD": fbd.fb_dense}

    def counts():
        torch.cuda.synchronize()
        return {k: c.launches for k, c in counters.items()}

    plain_on_card = {}

    plain = [(tb, "banded_sentence_forward"), (tb, "backtrace_batch"),
             (vt, "viterbi_banded_batch_plain"), (tf, "_banded_trellis_final"),
             (tsf, "_plain_search"), (tsf, "forward_fast"),
             (dm, "viterbi_composite_batch_fast"), (em, "emission_plain"),
             (tdn, "dense_forward"), (tfb, "banded_fb_plain"),
             (tfb, "banded_fb_posteriors_plain"), (tf, "banded_fb_plain"),
             (tf, "banded_fb_posteriors_plain"), (sb, "_advance"), (sb, "_advance_banded"),
             (sb, "_advance_compact"), (tvc, "viterbi_composite_counted_batch_plain"),
             (gm, "viterbi_composite_grammar_batch_plain"),
             (tvd, "viterbi_composite_duration_batch_plain"),
             (tlk, "lattice_sum_passes_plain"), (tlk, "lattice_max_passes_plain"),
             (tlk, "kbest_forward_plain"), (fbd, "fb_dense_plain")]
    saved = [guard(plain_on_card, m, n) for m, n in plain]
    tmp = tempfile.mkdtemp(prefix="cli_phase_")
    log_file = os.path.join(tmp, "runtime.log")

    def run(script, argv, need, label=None):
        """One script's main(argv) in process: its printed lines, and the
        launches of each kernel during the run (checked against need)."""
        main = importlib.import_module(f"cs304_tpu_torch.scripts.{script}").main
        before = counts()
        t0 = time.perf_counter()
        out = run_in_process(main, [*argv, "--log-file", log_file])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        now = counts()
        rose = {k: now[k] - before[k] for k in counters}
        name = label or script
        log("cli", script=name, s=f"{wall:.3f}",
            launches=",".join(f"{k}:{v}" for k, v in rose.items() if v) or "none")
        for line in out.strip().splitlines()[-3:]:
            print("   |", line[:160], flush=True)
        check_launches(f"phase 28: {name}", rose, need)
        return out, rose

    try:
        corpus = SyntheticTIDigits(num_train_speakers=6, num_test_speakers=2,
                                   takes_per_digit=3, with_sentences=True)
        ck3, ck5, ck6 = (os.path.join(tmp, n) for n in ("ck3", "ck5", "ck6"))
        run("project3_train", ["--synthetic", "--checkpoint-dir", ck3, *CLI_KMEANS], ["K3"])
        # What project3_predict computes, on the card and on the CPU
        # (where matplotlib is absent the script itself cannot run).
        digits = load_models(ck3, labels=list(DIGIT_LABELS))
        mc = ModelCollection.from_models([digits[w] for w in DIGIT_LABELS], device=dev)
        mc_cpu = ModelCollection.from_models([digits[w] for w in DIGIT_LABELS], device="cpu")
        for split, data in (("train", corpus.train_dataset), ("test", corpus.test_dataset)):
            truths = [w for w in DIGIT_LABELS for _ in data[w]]
            feats = mfcc_batch([c for w in DIGIT_LABELS for c in data[w]], device=dev)
            labels = mc.predict_batch(feats)
            if labels != mc_cpu.predict_batch(feats):
                raise SystemExit(f"phase 28: ModelCollection on the card differs from the "
                                 f"CPU's on the {split} split")
            log("cli", check="project3_predict", split=split, clips=len(truths),
                accuracy=float(np.mean([a == b for a, b in zip(labels, truths)])),
                cpu_labels_equal=True)
        # The GMM options (slice 10): K = 4 with Baum-Welch, one iteration of
        # each trainer (tests/test_torch_cli_train_gmm.py's setting), on the
        # card and with --device cpu; the models within that test's bound.
        gmm_cks = {d: os.path.join(tmp, f"ck3_gmm_{d}") for d in ("card", "cpu")}
        for where, opts, need in (("card", [], ["K3", "FBD"]), ("cpu", ["--device", "cpu"], [])):
            _out, rose = run("project3_train", [
                "--synthetic", "--checkpoint-dir", gmm_cks[where], "--gmm-mixtures", "4",
                "--baum-welch", *CLI_GMM_ONE_ITERATION, *opts], need,
                label=f"project3_train_gmm4_bw_{where}")
            if where == "card" and rose["FBD"] != len(DIGIT_LABELS):
                raise SystemExit(f"phase 28: project3_train --baum-welch launched FBD "
                                 f"{rose['FBD']} times for {len(DIGIT_LABELS)} words")
            if where == "cpu" and any(rose.values()):
                raise SystemExit(f"phase 28: project3_train --device cpu launched {rose}")
        got, want = (load_models(gmm_cks[d]) for d in ("card", "cpu"))
        worst = {}
        for w in want:
            for name, (k, rtol, atol) in BW_BOUND.items():
                a, b = getattr(got[w], name), getattr(want[w], name)
                fin = np.isfinite(b)
                same_inf = np.array_equal(np.isfinite(a), fin)
                r = float((np.abs(a[fin] - b[fin]) / (atol + rtol * np.abs(b[fin]))).max())
                worst[name] = max(worst.get(name, 0.0), r if same_inf else np.inf)
        within = sorted(got) == sorted(want) and all(
            worst[n] <= BW_BOUND[n][0] for n in BW_BOUND)
        log("cli", check="project3_train_gmm4_bw_card_vs_cpu", within=within,
            in_tolerance_units=json.dumps({k: round(v, 4) for k, v in worst.items()}),
            bound=json.dumps({k: v[0] for k, v in BW_BOUND.items()}))
        if not within:
            raise SystemExit(f"phase 28: project3_train --gmm-mixtures 4 --baum-welch on the "
                             f"card differs from --device cpu past the bound: {worst}")
        run("project5_train_no_empty", ["--synthetic", "--checkpoint-dir", ck5, *CLI_KMEANS],
            ["K3"])
        state = os.path.join(tmp, "state")
        run("project6_train", ["--synthetic", "--checkpoint-dir", ck5, "--out-dir", ck6,
                               "--state-dir", state, *CLI_EMBEDDED], ["K3"])
        # Library parity: the same trainer on the same inputs, bitwise.
        cfg = Config()
        cfg.apply_overrides(CLI_EMBEDDED[1::2])
        mcfg = cfg.frontend.mfcc_config()
        labeled = {t: mfcc_batch(u, cfg=mcfg, device=dev) for n in range(2, 8)
                   for t, u in corpus.train_dataset.get_all_n_digits(n).items()}
        trainer = ContinuousTrainer(load_models(ck5), ContinuousTrainConfig(
            max_iterations=cfg.continuous.max_iterations, cov_reg=cfg.continuous.cov_reg,
            silence_bootstrap=cfg.continuous.silence_bootstrap,
            insert_silence=cfg.continuous.insert_silence, update=cfg.continuous.update),
            device=dev)
        trainer.train(labeled, checkpoint_dir=os.path.join(tmp, "state_library"))
        want, got = trainer.models(), load_models(ck6)
        same = sorted(want) == sorted(got) and all(
            np.array_equal(np.asarray(getattr(want[w], f), np.float32), getattr(got[w], f))
            for w in want for f in ("means", "covariances", "log_a"))
        log("cli", check="project6_train_vs_ContinuousTrainer", bitwise=same, labels=len(got))
        if not same:
            raise SystemExit("phase 28: project6_train's parameters differ from a direct "
                             "ContinuousTrainer run on the card")
        run("project6_train", ["--synthetic", "--checkpoint-dir", ck5, "--out-dir",
                               os.path.join(tmp, "ck6_bw"), "--set",
                               "continuous.update=baum_welch", *CLI_EMBEDDED],
            ["E-step"], label="project6_train_baum_welch")
        run("project6_train", ["--synthetic", "--checkpoint-dir", ck5, "--out-dir",
                               os.path.join(tmp, "ck6_gmm"), "--gmm-mixtures", "2",
                               *CLI_EMBEDDED], ["K3"], label="project6_train_gmm2")
        nd = os.path.join(tmp, "ndigits")
        run("project5_test_ndigits", ["--synthetic", "--checkpoint-dir", ck6,
                                      "--n-digits", "4", "--csv-out", nd], ["K2"])
        for split in ("train", "test"):
            rows = list(CSVReader(f"{nd}.{split}.csv"))
            acc = float(np.mean([r["Ground Truth"] == r["Predict"] for r in rows]))
            log("cli", check="ndigits_csv", split=split, rows=len(rows), accuracy=acc,
                bar=CLI_ACC_BAR)
            if not rows or acc < CLI_ACC_BAR:
                raise SystemExit(f"phase 28: {split} n-digit CSV accuracy {acc} < {CLI_ACC_BAR}")
        run("project5_test_ndigits", ["--synthetic", "--checkpoint-dir", ck6, "--n-digits", "4",
                                      "--bigram-lm"], ["K2-lm"], label="project5_test_ndigits_lm")
        if importlib.util.find_spec("matplotlib") is not None:
            cwd = os.getcwd()
            os.chdir(tmp)  # the plots go to ./plots
            try:
                run("project3_predict", ["--synthetic", "--checkpoint-dir", ck3], ["K3"])
                run("project5_find_trans_penalty", [
                    "--synthetic", "--checkpoint-dir", ck6, "--stop", "-200", "--step", "-100",
                    "--max-per-label", "2"], ["K2"])
            finally:
                os.chdir(cwd)
        else:
            log("cli", not_run="project3_predict,project5_find_trans_penalty",
                reason="no_matplotlib")

        # -- decoding WAVs ----------------------------------------------------
        wavs = []
        for text, spk, seed in CLI_SENTENCES:
            wavs.append(os.path.join(tmp, f"{text}.wav"))
            write_wav_int16(wavs[-1], corpus.sentence_audio(text, spk, jitter_seed=seed), 16000)
        base = ["--checkpoint-dir", ck6] + [a for w in wavs for a in ("--wav", w)]
        out, _ = run("transcribe", base, ["K2"])
        texts = transcripts_of(out)
        feats = []
        for w in wavs:
            rate, signal = read_wav(w)
            feats.append(mfcc_batch([signal], cfg=replace(mcfg, sample_rate=float(rate)),
                                    device=dev)[0])
        library = dm.ContinuousDecoder(load_models(ck6), penalty=-100.0,
                                       device=dev).predict_batch(feats)
        log("cli", check="transcribe_vs_ContinuousDecoder", equal=[t for _w, t in texts] == library,
            exact=sum(t == s[0] for (_w, t), s in zip(texts, CLI_SENTENCES)), of=len(wavs))
        if [t for _w, t in texts] != library or [w for w, _t in texts] != wavs:
            raise SystemExit(f"phase 28: transcribe {texts} != predict_batch {library}")
        run("transcribe", base + ["--fast"], ["K1-split", "K2"], label="transcribe_fast")
        run("transcribe", base + ["--confidence", "--timings"], ["K4", "K2-bt", "LSUM"],
            label="transcribe_confidence_timings")
        run("transcribe", base + ["--beam", "50"], ["K2-beam"], label="transcribe_beam")
        # Device parity: the plain decode and each constrained one
        # (counted, grammar, duration: the PLANES or DURATION kernel on the
        # card, which walks its own path: no K2-bt) with --device cpu on the
        # same WAVs print the card's transcripts and touch the card nowhere.
        grammar = ",".join(s[0] for s in CLI_SENTENCES)
        for what, opts, need in (
                ("", [], []), ("_known_count", ["--known-count", "3"], ["PLANES"]),
                ("_grammar", ["--grammar-strings", grammar], ["PLANES"]),
                ("_min_duration", ["--min-duration", "2"], ["DURATION"])):
            on_card = texts
            if opts:
                out, rose = run("transcribe", base + opts, need, label=f"transcribe{what}")
                if rose["K2-bt"]:
                    raise SystemExit(f"phase 28: transcribe{what} launched K2-bt where its "
                                     f"kernel walks: {rose}")
                on_card = transcripts_of(out)
            allocations = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
            out_cpu, rose = run("transcribe", base + opts + ["--device", "cpu"], [],
                                label=f"transcribe{what}_cpu")
            touched = torch.cuda.memory_stats().get("allocation.all.allocated", 0) - allocations
            equal = transcripts_of(out_cpu) == on_card
            log("cli", check=f"transcribe{what}_cpu_vs_card", equal=equal,
                card_kernels=sum(rose.values()), card_allocations=touched)
            if not equal or any(rose.values()) or touched:
                raise SystemExit(f"phase 28: transcribe{what} --device cpu differs from the "
                                 f"card's, or touched the card ({rose}, {touched} allocations)")
        align_csv = os.path.join(tmp, "align.csv")
        run("align", ["--checkpoint-dir", ck6, "--wav", wavs[0], "--transcript", "375",
                      "--states", "--csv-out", align_csv], ["K3"])
        rows = list(CSVReader(align_csv))
        words = [r["word"] for r in rows]
        spans = [(r["start_frame"], r["end_frame"]) for r in rows]
        ordered = all(s < e for s, e in spans) and all(
            a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        log("cli", check="align", words="".join(words), frames=spans, increasing=ordered)
        if words != ["3", "7", "5"] or not ordered:
            raise SystemExit(f"phase 28: align gave {words} {spans}")
        run("adapt_speaker", ["--checkpoint-dir", ck6, "--out-dir", os.path.join(tmp, "adapted"),
                              "--wav", wavs[0], "--transcript", "375", "--tau", "10"], ["K3"])
        run("project6_interactive", ["--checkpoint-dir", ck6, "--wav", wavs[0], "--nbest", "3",
                                     "--confidence", "--spot", "7", "--lattice-dot",
                                     os.path.join(tmp, "lattice.dot")],
            ["K4", "K2-bt", "LSUM", "LMAX", "KBEST"])
        lm_file = os.path.join(tmp, "transcripts.txt")
        with open(lm_file, "w") as f:
            f.write("\n".join(PIPELINE_TRANSCRIPTS + [s[0] for s in CLI_SENTENCES]) + "\n")
        out, _ = run("project6_interactive", ["--checkpoint-dir", ck6, "--wav", wavs[0],
                                              "--rescore-lm", lm_file], ["LMAX", "K3-bp"],
                     label="project6_interactive_rescore_lm")
        if "rescored:" not in out:
            raise SystemExit(f"phase 28: project6_interactive --rescore-lm printed {out!r}")
        run("train_phones", ["--iterations", "3", "--out-dir", os.path.join(tmp, "phones")],
            ["K3"])
        run("demo_serving", ["--checkpoint-dir", ck6], ["K4", "K2-bt", "K2"])
        if plain_on_card:
            raise SystemExit(f"phase 28: a plain version ran on the card: {plain_on_card}")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log("phase", which="28 command line", seconds=f"{seconds:.2f}", budget=CLI_BUDGET_S,
        plain_on_card=json.dumps(plain_on_card), card=card)
    if seconds > CLI_BUDGET_S:
        raise SystemExit(f"phase 28: {seconds:.1f} s, over its {CLI_BUDGET_S} s budget")


DP_ITERATIONS = 3  # phases 8 and 20's run length
DP_GLOO_RANKS = 2
DP_GLOO_TIMEOUT_S = 240


# The gloo ranks' runs: (update, iterations). Baum-Welch is held to the
# bound after one iteration; after three it is logged beside the distance
# that another chunking of the corpus (another summation order) gives on one
# device: Baum-Welch on this corpus magnifies a last-bit difference from one
# iteration to the next, past the bound either way. Each of the three is
# held instead from the single device's models (out["baum_welch_forced"]).
DP_GLOO_RUNS = {"viterbi": ("viterbi", DP_ITERATIONS), "baum_welch_1": ("baum_welch", 1),
                "baum_welch": ("baum_welch", DP_ITERATIONS)}


def dp_trainer_config(update, iterations=DP_ITERATIONS):
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig

    return ContinuousTrainConfig(max_iterations=iterations, silence_bootstrap=False,
                                 cov_reg=0.1, on_empty_state="keep", update=update)


def dp_params(trainer):
    return tuple(np.asarray(getattr(trainer, n)) for n in ("means_g", "covs_g", "log_a_g"))


def same_bits(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
               for x, y in zip(a, b))


def within(got, want, rtol=1e-4, atol=2e-5):
    """tests/test_fused_training.py:74-80's bound (the CPU mesh tests'):
    -inf at the same places, the rest within rtol / atol."""
    ok, worst = True, 0.0
    for g, w in zip(got, want):
        fin = np.isfinite(w)
        ok &= bool((np.isfinite(g) == fin).all())
        ok &= bool(np.allclose(g[fin], w[fin], rtol=rtol, atol=atol))
        worst = max(worst, float(np.abs(g[fin] - w[fin]).max()))
    return ok, worst


def dp_gloo_rank(rank, folder):
    """One of phase 29's gloo ranks, both on cuda:0: DP_GLOO_RUNS' trainers
    over the 2-rank mesh on phase 8's corpus, their parameters, iterations
    and kernel launches written to folder."""
    import pickle
    from datetime import timedelta

    import torch.distributed as dist
    from cs304_tpu_torch.device import fp32_exact
    from cs304_tpu_torch.models.hmm import flagship_models
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainer
    from cs304_tpu_torch.ops.cuda import _build
    from cs304_tpu_torch.ops.cuda import trellis_banded as tb
    from cs304_tpu_torch.ops.cuda import trellis_fb as tfb
    from cs304_tpu_torch.parallel import data_parallel as dp

    dist.init_process_group("gloo", init_method=f"file://{folder}/store", rank=rank,
                            world_size=DP_GLOO_RANKS,
                            timeout=timedelta(seconds=DP_GLOO_TIMEOUT_S // 2))
    _build.load()
    fp32_exact()
    mesh = dp.make_mesh(devices=["cuda:0"] * DP_GLOO_RANKS)
    boot = {m.label: m for m in flagship_models(seed=0)}
    labeled = training_corpus(boot)
    out = {"device": str(dp.mesh_device(mesh)), "backend": dist.get_backend()}
    for name, (update, iterations) in DP_GLOO_RUNS.items():
        tb.banded_decode.launches = tfb.banded_fb_posteriors.launches = 0
        tr = ContinuousTrainer(dict(boot), dp_trainer_config(update, iterations), mesh=mesh)
        n = tr.train(labeled)
        out[name] = (n, dp_params(tr), {"K3": tb.banded_decode.launches,
                                        "E-step": tfb.banded_fb_posteriors.launches})
    # One Baum-Welch iteration from each of the single device's models
    # (forced.pkl, written by the parent process).
    with open(f"{folder}/forced.pkl", "rb") as f:
        forced = pickle.load(f)
    out["baum_welch_forced"] = []
    for models in forced:
        tfb.banded_fb_posteriors.launches = 0
        tr = ContinuousTrainer(dict(models), dp_trainer_config("baum_welch", 1), mesh=mesh)
        n = tr.train(labeled)
        out["baum_welch_forced"].append((n, dp_params(tr), tfb.banded_fb_posteriors.launches))
    dist.destroy_process_group()
    with open(f"{folder}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def data_parallel_phase(dev, card, decode, pipe):
    """Phase 29: data parallelism (parallel/data_parallel.py) on the card.

    A 1-rank NCCL group through make_mesh(): the Viterbi, Baum-Welch and
    K=2 GMM trainers over the mesh on phase 8's corpus, their parameters and
    iteration counts bitwise the single-device trainers' with the same K3
    and E-step launches (on one rank the sum is the identity);
    dp_composite_decode at the flagship (B=512, phase 5's features) with
    paths bitwise viterbi_composite_batch_pallas on the same whitening
    log_b, launching K4 and K2-bt; a ServingSessionPool over the mesh on
    phase 18's traffic with finals and partials equal to the pool without a
    mesh. The Viterbi iteration's wall time with and without the mesh, and
    the collectives' ms an iteration (each gather timed between two
    synchronizes, in a separate run). No plain version may run on a CUDA
    tensor.

    Then two gloo ranks, both on cuda:0, spawned here: each trains Viterbi
    (3 iterations) and Baum-Welch (1 and 3) over the 2-rank mesh; both
    ranks' parameters must be bitwise equal, with K3 and the E-step
    launched, and within the CPU mesh tests' bound (rtol 1e-4, atol 2e-5)
    of the single-device trainer's, except Baum-Welch after 3 iterations,
    whose distance is logged beside the single-device trainer's own
    distance to a run with another chunking (DP_GLOO_RUNS); each of those
    three iterations is held to the bound from the single device's models
    after the one before."""
    import functools
    import pickle
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from cs304_tpu_torch.models import train_fused as tf
    from cs304_tpu_torch.models.hmm import flagship_models
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainer
    from cs304_tpu_torch.models.train_continuous_gmm import (
        GMMContinuousTrainConfig,
        GMMContinuousTrainer,
        promote_to_gmm,
    )
    from cs304_tpu_torch.ops import streaming_batch as sb
    from cs304_tpu_torch.ops import viterbi as vt
    from cs304_tpu_torch.ops.cuda import trellis_banded as tb
    from cs304_tpu_torch.ops.cuda import trellis_dense as tdn
    from cs304_tpu_torch.ops.cuda import trellis_fb as tfb
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.cuda import trellis_stream as tst
    from cs304_tpu_torch.ops.gaussian import gaussian_log_pdf, make_gaussian_params
    from cs304_tpu_torch.parallel import data_parallel as dp
    from cs304_tpu_torch.serving import ServingSessionPool

    t_phase = time.perf_counter()
    if dist.is_initialized():
        raise SystemExit("phase 29: a process group exists before make_mesh()")
    mesh = dp.make_mesh()
    log("dp", group="make_mesh()", ranks=mesh.size(), backend=dist.get_backend(),
        device=dp.mesh_device(mesh), card=repr(card))
    if mesh.size() != 1 or dist.get_backend() != "nccl" or dp.mesh_device(mesh) != dev:
        raise SystemExit(f"phase 29: make_mesh() gave {mesh} on {dp.mesh_device(mesh)}")
    boot = {m.label: m for m in flagship_models(seed=0)}
    labeled = training_corpus(boot)
    plain_on_card = {}
    saved = [guard(plain_on_card, m, n) for m, n in (
        (tf, "_banded_trellis_final"), (tf, "banded_fb_posteriors_plain"),
        (tfb, "banded_fb_posteriors_plain"), (tb, "banded_sentence_forward"),
        (tdn, "dense_forward"), (tsf, "backtrace_batch"), (tsf, "forward_fast"),
        (vt, "viterbi_composite_batch"), (sb, "_advance"), (sb, "_advance_banded"),
        (sb, "_advance_compact"))]
    counters = {"K3": tb.banded_decode, "E-step": tfb.banded_fb_posteriors,
                "K4": tdn.trellis_dense_forward, "K2-bt": tsf.trellis_backtrace,
                "K2": tsf.scanfree_decode, "STREAM": tst.stream_advance}

    def launched():
        return {k: c.launches for k, c in counters.items()}

    def zero():
        for c in counters.values():
            c.launches = 0

    try:
        # -- the trainers: one rank's mesh against the single device -------
        single = {}
        for update in ("viterbi", "baum_welch"):
            runs = {}
            for name, kw in (("single", dict(device=dev)), ("mesh", dict(mesh=mesh))):
                zero()
                tr = ContinuousTrainer(dict(boot), dp_trainer_config(update), **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = tr.train(labeled)
                torch.cuda.synchronize()
                runs[name] = (n, dp_params(tr), launched(), time.perf_counter() - t0, tr)
            (n_s, p_s, l_s, _t, tr_s), (n_m, p_m, l_m, _t2, _tr) = runs["single"], runs["mesh"]
            single[update] = (n_s, p_s, tr_s)
            kernel = "K3" if update == "viterbi" else "E-step"
            ok = n_s == n_m and same_bits(p_s, p_m) and l_s == l_m and l_m[kernel] > 0
            log("dp", trainer=update, ranks=1, iterations=f"{n_m}/{n_s}",
                params_bitwise_single=same_bits(p_s, p_m), launches_mesh=json.dumps(l_m),
                launches_single=json.dumps(l_s))
            if not ok:
                raise SystemExit(f"phase 29: the {update} trainer over a 1-rank mesh is not "
                                 f"bitwise the single-device trainer (or launched no {kernel})")
        gmm_runs = {}
        for name, kw in (("single", dict(device=dev)), ("mesh", dict(mesh=mesh))):
            zero()
            tr = GMMContinuousTrainer(promote_to_gmm(single["viterbi"][2].models(), 2),
                                      GMMContinuousTrainConfig(max_iterations=DP_ITERATIONS,
                                                               cov_reg=0.1), **kw)
            n = tr.train(labeled)
            gmm_runs[name] = (n, tuple(getattr(tr, a) for a in
                                       ("means_g", "covs_g", "weights_g", "log_a_g")),
                              launched())
        (n_s, p_s, l_s), (n_m, p_m, l_m) = gmm_runs["single"], gmm_runs["mesh"]
        log("dp", trainer="gmm K=2", ranks=1, iterations=f"{n_m}/{n_s}",
            params_bitwise_single=same_bits(p_s, p_m), launches_mesh=json.dumps(l_m))
        if not (n_s == n_m and same_bits(p_s, p_m) and l_s == l_m and l_m["K3"] > 0):
            raise SystemExit("phase 29: the GMM trainer over a 1-rank mesh is not bitwise "
                             "the single-device trainer")

        # The gloo ranks' yardsticks on one device: Baum-Welch after one
        # iteration; each of three iterations run one at a time from the
        # models the one before left (forced[k]: after k iterations), which
        # the ranks start from too; and another chunking of the corpus after
        # one and after three iterations (how far the iterations magnify a
        # last-bit difference of the sums' order).
        tr = ContinuousTrainer(dict(boot), dp_trainer_config("baum_welch", 1), device=dev)
        single["baum_welch_1"] = (tr.train(labeled), dp_params(tr), tr)
        forced, forced_params = [dict(boot)], []
        for _ in range(DP_ITERATIONS):
            tr = ContinuousTrainer(forced[-1], dp_trainer_config("baum_welch", 1), device=dev)
            tr.train(labeled)
            forced_params.append(dp_params(tr))
            forced.append(tr.models())

        def chunked_32(iterations):
            chunked = functools.partial(tf.prepare_fused_corpus, chunk_utts=32)
            unchunked, tf.prepare_fused_corpus = tf.prepare_fused_corpus, chunked
            try:
                tr = ContinuousTrainer(dict(boot), dp_trainer_config("baum_welch", iterations),
                                       device=dev)
                tr.train(labeled)
            finally:
                tf.prepare_fused_corpus = unchunked
            return dp_params(tr)

        chunk_spread = within(chunked_32(DP_ITERATIONS), single["baum_welch"][1])[1]
        chunk_spread_1 = within(chunked_32(1), single["baum_welch_1"][1])[1]

        # -- the Viterbi iteration's wall time, with and without the mesh ----
        def iteration_ms(**kw):
            tr = ContinuousTrainer(dict(boot), dp_trainer_config("viterbi"), **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = tr.train(labeled)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        it_ms = {"single": [], "mesh": []}
        for name in ("single", "mesh", "mesh", "single", "single", "mesh"):
            it_ms[name].append(iteration_ms(**({"mesh": mesh} if name == "mesh"
                                               else {"device": dev})))
        gathers = {"calls": 0, "ms": 0.0, "bytes": 0}
        untimed = dp._all_gather

        def timed_gather(x, m):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = untimed(x, m)
            torch.cuda.synchronize()
            gathers["ms"] += (time.perf_counter() - t0) * 1e3
            gathers["calls"] += 1
            gathers["bytes"] += x.numel() * x.element_size()
            return out

        dp._all_gather = timed_gather
        try:
            tr = ContinuousTrainer(dict(boot), dp_trainer_config("viterbi"), mesh=mesh)
            n_timed = tr.train(labeled)
        finally:
            dp._all_gather = untimed
        log("timing", what="viterbi iteration (phase 8's corpus)", card=repr(card),
            ms_single=min(it_ms["single"]), ms_mesh_1rank=min(it_ms["mesh"]),
            ms_single_all=json.dumps([round(x, 3) for x in it_ms["single"]]),
            ms_mesh_all=json.dumps([round(x, 3) for x in it_ms["mesh"]]))
        log("timing", what="collectives a viterbi iteration (1 NCCL rank, each gather "
            "between two synchronizes)", card=repr(card),
            gathers=gathers["calls"] / n_timed, ms=gathers["ms"] / n_timed,
            bytes=gathers["bytes"] / n_timed)

        # -- dp_composite_decode at the flagship -------------------------------
        comp = decode["comp"]
        b, t_total = decode["lb3"].shape[:2]
        batch = decode["frames"].reshape(b, t_total, -1)
        lengths = decode["n_frames"].to(torch.int32)
        zero()
        scores, paths = dp.dp_composite_decode(
            comp.means, comp.covariances, comp.log_a, comp.lower_of_state, comp.is_entry,
            comp.is_exit, comp.penalty, batch, lengths, mesh)
        torch.cuda.synchronize()
        dec_launches = launched()
        log_b = gaussian_log_pdf(make_gaussian_params(comp.means, comp.covariances,
                                                      device=dev), batch)
        w_scores, w_paths = tdn.viterbi_composite_batch_pallas(
            log_b, comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
            comp.penalty, lengths)
        dec_ok = torch.equal(paths, w_paths) and torch.equal(scores, w_scores)
        log("dp", what="dp_composite_decode", B=b, T=t_total, paths_bitwise=dec_ok,
            launches=json.dumps(dec_launches), finite=bool(torch.isfinite(scores).all()))
        if not (dec_ok and dec_launches["K4"] > 0 and dec_launches["K2-bt"] > 0):
            raise SystemExit("phase 29: dp_composite_decode differs from K4 + K2-bt, or did "
                             "not launch them")

        # -- the serving pool over the mesh, phase 18's traffic ----------------
        audio, warm = serving_traffic(pipe["corpus"])
        serve = {}
        for name, kw in (("mesh", dict(mesh=mesh)), ("single", dict(device="cuda"))):
            zero()
            pool = ServingSessionPool(pipe["models"], num_slots=64, max_frames=4096, **kw)
            results, polls, wall, round_ms = drive_sessions(pool, range(SERVE_SESSIONS),
                                                            audio, warm)
            serve[name] = ([[(r.text, r.num_samples, r.last_partial) for r in rs]
                            for rs in results], polls, round_ms, launched())
        serve_ok = serve["mesh"][:2] == serve["single"][:2]
        n_finals = sum(len(rs) for rs in serve["mesh"][0])
        log("dp", what="ServingSessionPool(mesh=)", sessions=SERVE_SESSIONS, finals=n_finals,
            finals_and_partials_equal_single=serve_ok,
            launches=json.dumps(serve["mesh"][3]))
        log("timing", what="serving feed() round", card=repr(card),
            ms_mesh_1rank=serve["mesh"][2], ms_single=serve["single"][2])
        if not serve_ok or n_finals < SERVE_SESSIONS:
            raise SystemExit("phase 29: the serving pool over the mesh differs from the pool "
                             "without one")
        if not all(serve["mesh"][3][k] > 0 for k in ("K4", "K2-bt", "K2")):
            raise SystemExit(f"phase 29: a kernel of the meshed serving path never launched: "
                             f"{serve['mesh'][3]}")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        dist.destroy_process_group()
    if plain_on_card:
        raise SystemExit(f"phase 29: a plain version ran on a CUDA tensor: {plain_on_card}")

    # -- two gloo ranks on cuda:0 ---------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dp_gloo_") as folder:
        with open(f"{folder}/forced.pkl", "wb") as f:
            pickle.dump(forced[:-1], f)
        ctx = mp.start_processes(dp_gloo_rank, args=(folder,), nprocs=DP_GLOO_RANKS,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=max(0.0, DP_GLOO_TIMEOUT_S
                                           - (time.perf_counter() - t0))):
                if time.perf_counter() - t0 >= DP_GLOO_TIMEOUT_S:
                    raise SystemExit(f"phase 29: the gloo ranks still ran after "
                                     f"{DP_GLOO_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        ranks = []
        for rank in range(DP_GLOO_RANKS):
            with open(f"{folder}/rank{rank}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    for name, (update, iterations) in DP_GLOO_RUNS.items():
        n_s, p_s, _tr = single[name]
        (n0, p0, l0), (n1, p1, l1) = ranks[0][name], ranks[1][name]
        ok, worst = within(p0, p_s)
        # Three free-running Baum-Welch iterations magnify the sums' last-bit
        # differences past the bound, and past twice the single device's
        # spread under another chunking (6.5x on an H100): logged; each
        # of the three is held below, from the single device's models.
        held = not (update == "baum_welch" and iterations > 1)
        kernel = "K3" if update == "viterbi" else "E-step"
        log("dp", trainer=update, iterations=f"{n0}/{n1}/{n_s}", ranks=DP_GLOO_RANKS,
            backend=ranks[0]["backend"], devices=f"{ranks[0]['device']},{ranks[1]['device']}",
            ranks_bitwise=n0 == n1 and same_bits(p0, p1), within_single=ok,
            max_abs_delta_single=worst, gated=held,
            single_device_chunk_32_delta=(chunk_spread_1 if iterations == 1 else chunk_spread),
            launches=json.dumps([l0, l1]), seconds=f"{time.perf_counter() - t0:.1f}")
        if not (n0 == n1 == n_s and same_bits(p0, p1) and (ok or not held)
                and l0[kernel] > 0 and l1[kernel] > 0):
            raise SystemExit(f"phase 29: the {update} trainer over 2 gloo ranks ({iterations} "
                             f"iterations): ranks differ, or stray from the single-device "
                             f"trainer, or launched no {kernel}")
    for k, ((n0, p0, l0), (n1, p1, l1)) in enumerate(zip(ranks[0]["baum_welch_forced"],
                                                         ranks[1]["baum_welch_forced"])):
        ok, worst = within(p0, forced_params[k])
        log("dp", trainer="baum_welch", iteration=k + 1,
            start=f"the single device's models after {k}", ranks=DP_GLOO_RANKS,
            ranks_bitwise=same_bits(p0, p1), within_single=ok, max_abs_delta_single=worst,
            gated=True, launches=json.dumps([l0, l1]))
        if not (n0 == n1 == 1 and same_bits(p0, p1) and ok and l0 == l1 == 1):
            raise SystemExit(f"phase 29: Baum-Welch iteration {k + 1} over 2 gloo ranks from "
                             f"the single device's models: ranks differ, stray from the "
                             f"single-device iteration, or launched the E-step {l0} / {l1} "
                             f"times")
    if len(ranks[0]["baum_welch_forced"]) != DP_ITERATIONS:
        raise SystemExit("phase 29: the gloo ranks ran no forced Baum-Welch iteration")
    log("timing", what="phase 29", card=repr(card), seconds=time.perf_counter() - t_phase)


# -- phase 32: slice 10 -----------------------------------------------------

# FBD's cases beside the word shape: name -> (B, T, S, matrix, pinned final).
FBD_CASES = {
    "word": (256, 128, 5, "uniform", False),  # 5-state words, 256 clips of T = 128
    "word-banded-final": (256, 128, 5, "banded", True),
    "S1": (8, 40, 1, "uniform", True),
    "S2-T1": (8, 1, 2, "uniform", False),
    "dead-column": (16, 64, 9, "dead", False),
    "S128": (4, 100, 128, "uniform", True),
    # Each build of the plan (w8 / w16 / w32 / b64 / b128) on a learned-
    # looking matrix (scattered -inf entries, a dead row and column) or a
    # banded one with a pinned final; a long row at S = 5.
    "word-learned": (64, 128, 5, "learned", False),
    "S16-banded-final": (32, 64, 16, "banded", True),
    "S32-learned": (32, 64, 32, "learned", False),
    "S100-banded-final": (8, 64, 100, "banded", True),
    "S5-long": (16, 600, 5, "left-to-right", False),
}
# The main path's word call as a seeded shape (kernel_ab.py's "wordcall"):
# B=18 clips of lengths 20..37 padded to T=128, a left-to-right log_a.
FBD_WORD_CALL = (18, 128, 5, "left-to-right", False, (20, 37))
WORD_BW_MIXTURES = 4  # the reference's NUM_MIXTURES
# tests/test_torch_cli_train_gmm.py's bound after one Baum-Welch iteration,
# in units of tests/test_torch_gmm.py's _assert_gmm_model tolerances.
BW_BOUND = {"means": (20, 1e-4, 1e-4), "covariances": (20, 1e-3, 1e-4),
            "weights": (1, 1e-4, 1e-4), "log_a": (1, 1e-4, 1e-4)}


def fbd_problem(dev, b, t, s, kind, pinned, seed, lengths=None):
    """A seeded FBD problem on the card (tests/test_torch_cuda_kernels.py's
    _fbd_case): a uniform upper-triangular log_a, its banded matrix, one
    with an all -inf column, a left-to-right one (random self-loop and next
    probabilities, -inf elsewhere: a trained word model's pattern) or a
    learned-looking dense one (scattered -inf entries, a dead row and
    column; log_init zeros); emissions N(0, 9); lengths ragged with rows of
    0, 1 and past T (row 0 the full T), or uniform in lengths = (lo, hi); a
    final pinned at the last state where the case says (the short rows
    cannot reach it: ll = -inf)."""
    from cs304_tpu_torch.models.hmm import uniform_forward_log_a
    from cs304_tpu_torch.ops.viterbi import banded_transition_matrix

    gen = torch.Generator().manual_seed(seed)
    log_a = torch.as_tensor(uniform_forward_log_a(s))
    if kind == "banded":
        log_a = banded_transition_matrix(log_a)
    if kind == "dead":
        log_a[:, 3] = float("-inf")
    if kind == "left-to-right":
        stay = 0.3 + 0.6 * torch.rand((s,), generator=gen)
        stay[-1] = 1.0
        log_a = torch.full((s, s), float("-inf"))
        idx = torch.arange(s)
        log_a[idx, idx] = torch.log(stay)
        log_a[idx[:-1], idx[1:]] = torch.log1p(-stay[:-1])
    if kind == "learned":
        a = 0.05 + 0.95 * torch.rand((s, s), generator=gen)
        a[torch.rand((s, s), generator=gen) < 0.5] = 0.0
        a[torch.arange(s), torch.arange(s)] = 0.2 + 0.8 * torch.rand((s,), generator=gen)
        if s >= 3:
            a[:, s // 2] = 0.0
            a[s // 3, :] = 0.0
        log_a = torch.log(a / a.sum(dim=1, keepdim=True).clamp(min=1e-30))
    log_b = 3 * torch.randn((b, t, s), generator=gen)
    if lengths is not None:
        lengths = torch.randint(lengths[0], lengths[1] + 1, (b,), generator=gen,
                                dtype=torch.int32)
    else:
        lengths = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32)
        lengths[0] = t
        lengths[1::4] = 1
        lengths[2::5] = 0
        lengths[3::6] = t + 3
    log_init = torch.full((s,), float("-inf"))
    log_init[0] = 0.0
    if kind == "learned":
        log_init[:] = 0.0
    final = None
    if pinned:
        final = torch.full((s,), float("-inf"))
        final[-1] = 0.0
        final = final.to(dev)
    return (log_b.to(dev), log_a.contiguous().to(dev), log_init.to(dev), lengths.to(dev),
            final)


def fbd_bound(b, t, s, lengths, mode, log_a):
    """bound() of one FBD call: the live log_b rows, log_a, log_init,
    log_final and lengths in; alpha, beta or gamma (every row), xi and ll
    out. FP32 operations over the steps these lengths need and the entries
    of log_a that are not -inf (a -inf entry adds exactly nothing to a sum,
    so a kernel that knows the matrix does no work for it): per (chain step,
    finite entry) 5 (an add, a max, a subtract, an exp and the sum's add)
    and per (chain step, state) 3 (a log, the max added back, and the
    emission's add: log_b to the sum in the forward, to beta in the
    backward); per (live row, state) 3 for gamma (add, subtract, exp); per
    (pair, finite entry) 4 for xi (the add of the destination's term to
    alpha + log_a, which the forward step already formed, a subtract, an
    exp and the sum's add) and per (pair, state) 1 (log_b + beta). Every
    operation, exp and log included, is counted once at PEAK_FP32_ALU: an
    IEEE expf or logf takes several instructions, so the bound stays a
    lower bound."""
    n = lengths.clamp(min=0, max=t)
    live, steps = int(n.sum().item()), int((n - 1).clamp(min=0).sum().item())
    finite = int((log_a != float("-inf")).sum().item())
    moved_in = 4 * live * s + 4 * s * s + 8 * s + 4 * b
    per_step = steps * (5 * finite + 3 * s)
    if mode == "forward":
        return bound(moved_in + 4 * b * t * s + 4 * b, [(per_step, PEAK_FP32_ALU)])
    if mode == "backward":
        return bound(moved_in + 4 * b * t * s, [(per_step, PEAK_FP32_ALU)])
    ops = 2 * per_step + 3 * live * s + steps * (4 * finite + s)
    return bound(moved_in + 4 * b * t * s + 4 * b * s * s + 4 * b, [(ops, PEAK_FP32_ALU)])


def fbd_skeleton_ms(args):
    """Device time of FBD's skeleton on one call's inputs (its plan's
    build, the forward's chain cut to its exchange: the floor of a step)."""
    from cs304_tpu_torch.ops.cuda import _build
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd

    log_b, log_a, log_init, lengths, final = args
    b, t, s = log_b.shape
    alpha = torch.empty_like(log_b)
    lib = _build.load()
    build = list(fbd.FBD_BUILDS).index(fbd.fb_dense_plan(s))

    def run():
        _build.check(lib.cs304_fb_dense_on(
            build, 3, log_b.data_ptr(), log_a.data_ptr(), log_init.data_ptr(),
            final.data_ptr() if final is not None else None, lengths.data_ptr(),
            alpha.data_ptr(), None, None, None, None, b, t, s,
            torch.cuda.current_stream().cuda_stream), "fb_dense skeleton")
    return device_ms(run)


def fbd_resources(s):
    """ptxas' registers and spill bytes of the posteriors kernel of the
    build that runs S states (the library's build log)."""
    from cs304_tpu_torch.ops.cuda import _build
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd

    path = _build.library_path().with_suffix(".log")
    build = fbd.fb_dense_plan(s)
    kind = "warp" if build.startswith("w") else "block"
    name = f"fb_dense_{kind}ILi2ELi{fbd.FBD_BUILDS[build][1]}E"
    return ptxas_resources(path.read_text() if path.exists() else "", re.compile(name))


def fbd_chain(lengths, t, mode):
    """The serial steps of one FBD call: the kernel walks each row to its
    own length, so the longest row sets the chain (T - 1 a direction at
    most; the posteriors walk both)."""
    n = int(lengths.clamp(min=0, max=t).max().item())
    return (2 if mode == "posteriors" else 1) * max(n - 1, 1)


def same_cells(got, want):
    """The same NaN, +inf, -inf and zero cells."""
    return all(bool(torch.equal(f(got), f(want))) for f in (
        torch.isnan, torch.isposinf, torch.isneginf, lambda x: x == 0))


def xi_rounding_probe(args, got, want, n_cells=64):
    """Where FBD's xi and its plain version differ: rebuild each differing
    cell's terms from the forward and backward modes (bitwise the plain
    version's alpha and beta), and count the cells whose value is the sum
    of exp(e) rounded once from float64 (correctly rounded terms), on each
    side; beside it, the terms whose value is subnormal, and whether the
    card's torch.exp rounds those as float64 does."""
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd

    log_b, log_a, log_init, lengths, final = args
    alpha, ll = fbd.fb_dense_plain(*args, mode="forward")
    beta = fbd.fb_dense_plain(*args, mode="backward")
    cells = (got.view(torch.int32) != want.view(torch.int32)) & ~torch.isnan(want)
    idx = cells.nonzero().tolist()[:n_cells]
    tiny = torch.finfo(torch.float32).tiny
    out = {"xi_cells": int(cells.sum()), "probed": len(idx), "kernel_correctly_rounded": 0,
           "plain_correctly_rounded": 0, "kernel_is_sum_of_normal_terms": 0,
           "kernel_is_ftz_sum": 0, "subnormal_terms": 0,
           "torch_exp_subnormal_terms_correctly_rounded": 0, "kernel_minus_plain_ulps": []}
    for bi, i, j in idx:
        n = min(int(lengths[bi]), log_b.shape[1])
        e = ((alpha[bi, : n - 1, i] + log_a[i, j]) + (log_b[bi, 1:n, j] + beta[bi, 1:n, j])) \
            - ll[bi]
        exact = torch.exp(e.double()).float()
        acc = acc_normal = acc_ftz = np.float32(0.0)
        for term in torch.exp(e).cpu().numpy():
            normal = term if term >= np.finfo(np.float32).tiny else np.float32(0.0)
            acc_normal = np.float32(acc_normal + normal)
            acc_ftz = np.float32(acc_ftz + normal)
            acc_ftz = acc_ftz if acc_ftz >= np.finfo(np.float32).tiny else np.float32(0.0)
        for term in exact.cpu().numpy():
            acc = np.float32(acc + term)
        k = np.float32(got[bi, i, j].item())
        out["kernel_correctly_rounded"] += int(k == acc)
        out["plain_correctly_rounded"] += int(np.float32(want[bi, i, j].item()) == acc)
        out["kernel_is_sum_of_normal_terms"] += int(k == acc_normal)
        out["kernel_is_ftz_sum"] += int(k == acc_ftz)
        if len(out["kernel_minus_plain_ulps"]) < 8:
            out["kernel_minus_plain_ulps"].append(
                int(got[bi, i, j].view(torch.int32)) - int(want[bi, i, j].view(torch.int32)))
        sub = (exact > 0) & (exact < tiny)
        out["subnormal_terms"] += int(sub.sum())
        out["torch_exp_subnormal_terms_correctly_rounded"] += int(
            (torch.exp(e)[sub] == exact[sub]).sum())
    return out


def fbd_expf_probe(dev, n=4096, lo=-103.9, hi=-87.4):
    """FBD's expf against torch.exp on the card: the posteriors mode at
    S = 2, T = 1, log_b[b, 0] = (0, x_b), so ll = log(1 + e^x) rounds to 0
    (x < -17) and gamma[b, 0, 1] = expf(x_b), for n values of x in
    [lo, hi] (by default results below float32's smallest normal), one
    launch. Counts of the kernel's and torch's values equal to exp(x)
    rounded once from float64, and of the two agreeing."""
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd

    x = torch.linspace(lo, hi, n, device=dev)
    log_b = torch.stack([torch.zeros_like(x), x], dim=1)[:, None, :].contiguous()
    gamma = fbd.fb_dense(log_b, torch.zeros((2, 2), device=dev), torch.zeros(2, device=dev),
                         torch.ones(n, dtype=torch.int32, device=dev))[0][:, 0, 1]
    exact = torch.exp(x.double()).float()
    ref = torch.exp(x)
    return {"values": n, "kernel_correctly_rounded": int((gamma == exact).sum()),
            "torch_exp_correctly_rounded": int((ref == exact).sum()),
            "kernel_equals_torch_exp": int((gamma == ref).sum())}


def slice10_phase(dev, pipe, launches, timings, errs, yardsticks, card):
    """Phase 32 (slice 10): FBD, the dense forward-backward
    (csrc/forward_backward.cu), against its plain version in all three
    modes, on seeded cases and on the legacy trainer's and each word's own
    calls; its timing (the largest word call's for the kernels line);
    isolated-word Baum-Welch at full width and the
    legacy trainer's Baum-Welch pass on it; project3_train --gmm-mixtures 4
    --baum-welch with FBD and with the plain loop on the card; lattice
    rescoring's arc scores on K3 and the associative decode's backtrace on
    K2-bt."""
    import os
    import shutil
    import tempfile

    from cs304_tpu_torch.models import gmm_hmm as tg
    from cs304_tpu_torch.models.decoder import ContinuousDecoder
    from cs304_tpu_torch.models.hmm import flagship_composite
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig, ContinuousTrainer
    from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig
    from cs304_tpu_torch.ops import forward_backward as fb_ops
    from cs304_tpu_torch.ops import rescore as rs
    from cs304_tpu_torch.ops import viterbi as vt
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd
    from cs304_tpu_torch.ops.cuda import trellis_banded as tb
    from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
    from cs304_tpu_torch.ops.gaussian import gaussian_log_pdf
    from cs304_tpu_torch.ops.lattice import forward_lattice
    from cs304_tpu_torch.ops.lm import train_word_bigram
    from cs304_tpu_torch.ops.viterbi_assoc import viterbi_composite_assoc
    from cs304_tpu_torch.scripts._common import run_in_process

    t_phase = time.perf_counter()
    plain_on_card = {}
    guards = [(fbd, "fb_dense_plain"), (tb, "banded_sentence_forward"),
              (tsf, "backtrace_batch")]

    # -- FBD against its plain version --------------------------------------
    err = 0.0

    def fbd_check(name, args):
        """Each mode one launch, every output bitwise the plain version
        (NaN cells the same); where one is not, W5's measure (the same NaN
        / inf / zero cells, within 1e-5 * max(1, |x|)) and, for xi, the
        rounding probe are logged before the phase fails."""
        nonlocal err
        b_k, t_k, s_k = args[0].shape
        for mode in fbd.MODES:
            before = fbd.fb_dense.launches
            got = kernel_runs("fb_dense", fbd.fb_dense, *args, mode=mode)[0]
            torch.cuda.synchronize()
            one = fbd.fb_dense.launches == before + len(KERNEL_POISONS)
            want = plain_run(fbd.fb_dense_plain, *args, mode=mode)
            got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
            for i, (g, w) in enumerate(zip(got, want)):
                nan = torch.isnan(w)
                bits = bool(torch.equal(torch.isnan(g), nan)) and bool(torch.equal(
                    g[~nan].view(torch.int32), w[~nan].view(torch.int32)))
                fin = torch.isfinite(w)
                d = (g[fin] - w[fin]).abs()
                err = max(err, d.max().item() if d.numel() else 0.0)
                if not (one and bits):
                    what = f"{mode}:{('gamma', 'xi', 'll')[i] if mode == 'posteriors' else i}"
                    w5 = same_cells(g, w) and bool(
                        (d <= 1e-5 * w[fin].abs().clamp(min=1.0)).all())
                    if what == "posteriors:xi":
                        log("FBD-rounding", case=name, **xi_rounding_probe(args, g, w))
                    raise SystemExit(
                        f"phase 32: FBD's {what} disagrees with its plain version ({name}: "
                        f"cells {int((g.view(torch.int32) != w.view(torch.int32)).sum())}, "
                        f"W5 {w5}, one launch {one})")
            if mode != "backward":
                ll = got[-1]
                if not (bool(torch.isfinite(ll[0])) and not bool(torch.isnan(ll).any())):
                    raise SystemExit(f"phase 32: FBD case {name} does not reach row 0's end")
        log("FBD", case=name, B=b_k, T=t_k, S=s_k, final=args[4] is not None,
            neg_inf_ll=int(torch.isneginf(fbd.fb_dense(*args, mode="forward")[1]).sum()),
            modes=",".join(fbd.MODES), bitwise=True, one_launch_each=True)

    log("FBD-rounding", what="expf on subnormal results", **fbd_expf_probe(dev))
    log("FBD-rounding", what="expf on [-103.9, -17.5]",
        **fbd_expf_probe(dev, 1 << 20, -103.9, -17.5))
    word_args = None
    for name, (b_k, t_k, s_k, kind, pinned) in FBD_CASES.items():
        args = fbd_problem(dev, b_k, t_k, s_k, kind, pinned, seed=b_k + t_k + s_k)
        fbd_check(name, args)
        if name == "word":
            word_args = args

    # The legacy trainer's shape: the largest call of one legacy Baum-Welch
    # iteration at phase 8's corpus (a transcript group, pinned final).
    captured = []
    real = fb_ops.fb_dense

    def capture(*args):
        if args[0].shape[2] > (captured[0][0].shape[2] if captured else 0):
            captured[:] = [tuple(a.clone() if a is not None else None for a in args[:5])]
        return real(*args)

    fb_ops.fb_dense = capture
    try:
        legacy = ContinuousTrainer(dict(pipe["boot"]), ContinuousTrainConfig(
            max_iterations=1, silence_bootstrap=False, cov_reg=0.1, update="baum_welch",
            fused=False), device=dev)
        legacy.train(pipe["labeled"])
    finally:
        fb_ops.fb_dense = real
    fbd_check("legacy-sentence", captured[0])

    # -- FBD timing at the word shape ---------------------------------------
    def floor_us(args):
        """The skeleton's µs a forward chain step on these inputs."""
        return fbd_skeleton_ms(args) / fbd_chain(args[3], args[0].shape[1], "forward") * 1e3

    b_w, t_w, s_w = word_args[0].shape
    for mode in fbd.MODES:
        ms = device_ms(lambda: fbd.fb_dense(*word_args, mode=mode))
        plain_ms = cuda_ms(lambda: fbd.fb_dense_plain(*word_args, mode=mode), reps=2)
        b_ms, b_by = fbd_bound(b_w, t_w, s_w, word_args[3], mode, word_args[1])
        chain = fbd_chain(word_args[3], t_w, mode)
        log("timing", kernel=f"fb_dense:{mode}", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, chain_steps=chain, us_per_chain_step=ms / chain * 1e3,
            plain_us_per_chain_step=plain_ms / chain * 1e3, library_ms=None,
            shape=f"B={b_w} T={t_w} S={s_w}", build=fbd.fb_dense_plan(s_w), card=card)
    log("timing", kernel="fb_dense:skeleton", us_per_chain_step=floor_us(word_args),
        shape=f"B={b_w} T={t_w} S={s_w}", **fbd_resources(s_w), card=card)
    seeded_call = fbd_problem(dev, *FBD_WORD_CALL[:5], seed=151, lengths=FBD_WORD_CALL[5])
    fbd_check("word-call-seeded", seeded_call)
    sc_ms = device_ms(lambda: fbd.fb_dense(*seeded_call, mode="posteriors"))
    sc_chain = fbd_chain(seeded_call[3], FBD_WORD_CALL[1], "posteriors")
    log("timing", kernel="fb_dense:posteriors", ms=sc_ms, chain_steps=sc_chain,
        us_per_chain_step=sc_ms / sc_chain * 1e3, skeleton_us_per_step=floor_us(seeded_call),
        bound_ms=fbd_bound(*seeded_call[0].shape, seeded_call[3], "posteriors",
                           seeded_call[1])[0],
        shape="kernel_ab.py's wordcall (B=18 T=128 S=5, lengths 20..37)", card=card)
    leg = captured[0]
    b_l, t_l, s_l = leg[0].shape
    leg_ms = device_ms(lambda: fbd.fb_dense(*leg, mode="posteriors"))
    leg_plain = cuda_ms(lambda: fbd.fb_dense_plain(*leg, mode="posteriors"), reps=2)
    leg_bound = fbd_bound(b_l, t_l, s_l, leg[3], "posteriors", leg[1])
    leg_chain = fbd_chain(leg[3], t_l, "posteriors")
    log("timing", kernel="fb_dense:posteriors", ms=leg_ms, plain_ms=leg_plain,
        bound_ms=leg_bound[0], bound_by=leg_bound[1], chain_steps=leg_chain,
        us_per_chain_step=leg_ms / leg_chain * 1e3, skeleton_us_per_step=floor_us(leg),
        library_ms=None, shape=f"legacy B={b_l} T={t_l} S={s_l}",
        build=fbd.fb_dense_plan(s_l), **fbd_resources(s_l), card=card)

    # -- isolated-word Baum-Welch at full width (the slice's main path) ------
    feats = pipe["digit_feats"]
    km = SegmentalKMeansConfig(num_states=5, max_iterations=15)
    one_it = SegmentalKMeansConfig(num_states=5, max_iterations=1)
    init = {w: tg.train_gmm_hmm(w, f, num_mixtures=WORD_BW_MIXTURES, cfg=km, device=dev)
            for w, f in feats.items()}

    # The main path's own FBD calls: one Baum-Welch iteration a word, each
    # _bw_stats call captured (all of the word's clips, its GMM emissions,
    # its learned log_a) and held to the plain version; the largest is timed
    # for the kernels line.
    word_calls = {}

    def capture_word(*args):
        word_calls[current[0]] = tuple(a.clone() if a is not None else None for a in args[:5])
        return real(*args)

    current = [None]
    fb_ops.fb_dense = capture_word
    try:
        for w, f in feats.items():
            current[0] = w
            tg.train_gmm_hmm_baum_welch(w, f, WORD_BW_MIXTURES, one_it, init=init[w], device=dev)
    finally:
        fb_ops.fb_dense = real
    for w, args in word_calls.items():
        fbd_check(f"word-bw:{w}", args)
    # The longest chain, then the most live frames.
    big_w = max(word_calls, key=lambda w: (
        fbd_chain(word_calls[w][3], word_calls[w][0].shape[1], "forward"),
        int(word_calls[w][3].sum().item())))
    big = word_calls[big_w]
    b_b, t_b, s_b = big[0].shape
    big_chain = fbd_chain(big[3], t_b, "posteriors")
    big_ms = device_ms(lambda: fbd.fb_dense(*big, mode="posteriors"))
    big_plain = cuda_ms(lambda: fbd.fb_dense_plain(*big, mode="posteriors"), reps=2)
    big_bound = fbd_bound(b_b, t_b, s_b, big[3], "posteriors", big[1])
    log("timing", kernel="fb_dense:posteriors", ms=big_ms, plain_ms=big_plain,
        bound_ms=big_bound[0], bound_by=big_bound[1], chain_steps=big_chain,
        us_per_chain_step=big_ms / big_chain * 1e3, skeleton_us_per_step=floor_us(big),
        library_ms=None, live_frames=int(big[3].clamp(max=t_b).sum().item()),
        finite_log_a=int((big[1] != float("-inf")).sum().item()),
        shape=f"word-bw {big_w!r} B={b_b} T={t_b} S={s_b}, the kernels line's row",
        build=fbd.fb_dense_plan(s_b), card=card)
    timings["fb_dense"] = (big_ms, big_plain)
    yardsticks["fb_dense"] = (None, *big_bound)
    saved = [guard(plain_on_card, m, n) for m, n in guards]
    calls = []
    real_stats = tg._bw_stats

    def counted_stats(*args, **kwargs):
        calls.append(1)
        return real_stats(*args, **kwargs)

    tg._bw_stats = counted_stats
    try:
        fbd.fb_dense.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_models = {w: tg.train_gmm_hmm_baum_welch(w, f, WORD_BW_MIXTURES, one_it,
                                                      init=init[w], device=dev)
                       for w, f in feats.items()}
        torch.cuda.synchronize()
        main_wall = time.perf_counter() - t0
        main_launches = fbd.fb_dense.launches
    finally:
        tg._bw_stats = real_stats
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    launches["fb_dense"] = main_launches
    cpu_models = {w: tg.train_gmm_hmm_baum_welch(w, f, WORD_BW_MIXTURES, one_it, init=init[w],
                                                 device="cpu") for w, f in feats.items()}
    worst = {}
    for w in feats:
        for name, (k, rtol, atol) in BW_BOUND.items():
            a, b = getattr(card_models[w], name), getattr(cpu_models[w], name)
            fin = np.isfinite(b)
            if not np.array_equal(np.isfinite(a), fin):
                raise SystemExit(f"phase 32: word {w}'s {name} is -inf in other places on "
                                 f"the card than on the CPU")
            r = float((np.abs(a[fin] - b[fin]) / (atol + rtol * np.abs(b[fin]))).max())
            worst[name] = max(worst.get(name, 0.0), r)
    within = all(worst[n] <= BW_BOUND[n][0] for n in BW_BOUND)
    log("word-bw", words=len(feats), K=WORD_BW_MIXTURES, clips=json.dumps(
        {w: len(f) for w, f in feats.items()}), fb_dense_launches=main_launches,
        bw_iterations=len(calls), wall_s=f"{main_wall:.3f}",
        card_vs_cpu_in_tolerance_units=json.dumps({k: round(v, 4) for k, v in worst.items()}),
        bound=json.dumps({k: v[0] for k, v in BW_BOUND.items()}), within=within)
    if not within or main_launches != len(calls) or main_launches < len(feats) \
            or plain_on_card:
        raise SystemExit(f"phase 32: word Baum-Welch on the card: within bound {within}, "
                         f"FBD launches {main_launches} for {len(calls)} iterations, plain "
                         f"on the card {plain_on_card}")

    # One Baum-Welch iteration over the 11 words: FBD against the plain loop
    # on the card (the path before this slice), host wall with readback.
    def bw_iteration_ms(use_kernel):
        fb_ops.fb_dense = real if use_kernel else fbd.fb_dense_plain
        try:
            t0 = time.perf_counter()
            for w, f in feats.items():
                tg.train_gmm_hmm_baum_welch(w, f, WORD_BW_MIXTURES, one_it, init=init[w],
                                            device=dev)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        finally:
            fb_ops.fb_dense = real

    walls = {True: [], False: []}
    for use_kernel in (False, True, True, False):
        walls[use_kernel].append(bw_iteration_ms(use_kernel))
    log("timing", what=f"word Baum-Welch iteration, {len(feats)} words x K={WORD_BW_MIXTURES}, "
                       f"host wall with readback",
        ms_fb_dense=min(walls[True]), ms_plain_loop_on_card=min(walls[False]),
        runs=json.dumps({"fb_dense": walls[True], "plain": walls[False]}), card=card)

    # project3_train --gmm-mixtures 4 --baum-welch, FBD and the plain loop.
    tmp = tempfile.mkdtemp(prefix="slice10_")
    try:
        from cs304_tpu_torch.scripts import project3_train

        p3 = {True: [], False: []}
        for run_i, use_kernel in enumerate((True, False, False, True)):
            fb_ops.fb_dense = real if use_kernel else fbd.fb_dense_plain
            try:
                t0 = time.perf_counter()
                run_in_process(project3_train.main, [
                    "--synthetic", "--checkpoint-dir", os.path.join(tmp, f"ck{run_i}"),
                    "--gmm-mixtures", "4", "--baum-welch", *CLI_KMEANS,
                    "--log-file", os.path.join(tmp, "runtime.log")])
                torch.cuda.synchronize()
                p3[use_kernel].append(time.perf_counter() - t0)
            finally:
                fb_ops.fb_dense = real
        log("timing", what="project3_train --gmm-mixtures 4 --baum-welch (CLI_KMEANS), wall s",
            s_fb_dense=min(p3[True]), s_plain_loop_on_card=min(p3[False]),
            runs=json.dumps({"fb_dense": p3[True], "plain": p3[False]}), card=card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- lattice rescoring on phase 22's clip 0 (arc scores on K3) ----------
    models = pipe["models"]
    clip0 = pipe["eval"]["train_speakers"][1][0]
    comp = ContinuousDecoder(models, penalty=-100.0, device=dev).composite
    log_b = comp.log_likelihoods(clip0, device=dev)
    lat = forward_lattice(comp, clip0, beam=500.0, log_b=log_b, device=dev)
    bigram = train_word_bigram(PIPELINE_TRANSCRIPTS, sorted(models), insert_silence=True)
    arcs = lat.sorted_arcs()
    saved = [guard(plain_on_card, m, n) for m, n in guards]
    try:
        before = (tb.banded_forward.launches, tsf.trellis_backtrace.launches)
        card_scores = kernel_runs("trellis_banded_forward", rs.arc_acoustic_scores, comp, arcs,
                                  log_b=log_b, device=dev)[0]
        card_best = kernel_runs("trellis_banded_forward", lambda: rs.lattice_rescore(
            comp, lat, log_b=log_b, bigram=bigram, lm_weight=1.0, device=dev)[:2])[0]
        torch.cuda.synchronize()
        k3_rescore = tb.banded_forward.launches - before[0]
        # The associative decode: the flagship on 4 of phase 22's clips.
        flag = flagship_composite()
        params = flag.emission_params(dev)
        topo = (flag.log_a, flag.lower_of_state, flag.is_entry, flag.is_exit, flag.penalty)
        assoc = []
        bt_before = tsf.trellis_backtrace.launches
        for f in pipe["eval"]["train_speakers"][1][:4]:
            lb = gaussian_log_pdf(params, torch.as_tensor(f, device=dev))
            assoc.append((lb, kernel_runs("trellis_backtrace", viterbi_composite_assoc, lb,
                                          *topo)[0]))
        torch.cuda.synchronize()
        bt_assoc = tsf.trellis_backtrace.launches - bt_before
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    cpu_scores = plain_run(rs.arc_acoustic_scores, comp, arcs, log_b=log_b.cpu(), device="cpu")
    cpu_best = plain_run(rs.lattice_rescore, comp, lat, log_b=log_b.cpu(), bigram=bigram,
                         lm_weight=1.0, device="cpu")
    bitwise = bool(np.array_equal(card_scores.view(np.int32), cpu_scores.view(np.int32)))
    log("rescore", clip="phase 22's clip 0", T=len(clip0), arcs=len(arcs),
        arc_scores_bitwise_cpu=bitwise, finite=int(np.isfinite(card_scores).sum()),
        k3_launches=k3_rescore, text=card_best[1], score=card_best[0],
        equal_cpu=card_best[:2] == cpu_best[:2], card=card)
    n_runs = len(KERNEL_POISONS)  # each call made under each poison
    if (not bitwise or card_best[:2] != cpu_best[:2] or k3_rescore != 2 * n_runs
            or plain_on_card):
        raise SystemExit(f"phase 32: rescoring on the card: arc scores bitwise {bitwise}, "
                         f"{card_best[:2]} vs {cpu_best[:2]}, K3 launches {k3_rescore} (2 "
                         f"calls, {n_runs} runs each), plain on the card {plain_on_card}")
    assoc_ok, assoc_err = True, 0.0
    for lb, (a_s, a_p) in assoc:
        w_s, w_p = plain_run(vt.viterbi_composite, lb, *topo, quirk_backtrace=False)
        c_s, c_p = plain_run(viterbi_composite_assoc, lb.cpu(), *topo)
        assoc_err = max(assoc_err, abs(float(a_s) - float(w_s)))
        assoc_ok &= bool(np.isclose(float(a_s), float(w_s), rtol=1e-4, atol=1e-3))
        assoc_ok &= bool(torch.equal(a_p, w_p)) and bool(torch.equal(a_p.cpu(), c_p))
        assoc_ok &= float(a_s) == float(c_s)
    log("assoc", clips=len(assoc), S=flag.num_states, k2_bt_launches=bt_assoc,
        paths_equal_sequential_and_cpu=assoc_ok, max_abs_score_err=assoc_err)
    if not assoc_ok or bt_assoc != n_runs * len(assoc):
        raise SystemExit(f"phase 32: viterbi_composite_assoc: equal {assoc_ok}, K2-bt "
                         f"launches {bt_assoc} for {len(assoc)} decodes")
    errs["fb_dense"] = err
    log("phase", which="32 slice 10", seconds=f"{time.perf_counter() - t_phase:.2f}", card=card)


def report(kind, launches, timings, errs, yardsticks):
    """The kernels' JSON line and the final line."""
    meta = {
        "emission": ("cs304_tpu_torch/csrc/emission.cu", "cs304_tpu/ops/pallas/emission.py:82"),
        "emission_split": ("cs304_tpu_torch/csrc/emission_split.cu",
                           "cs304_tpu/ops/pallas/emission.py:157"),
        "trellis_decode": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                           "cs304_tpu/ops/pallas/trellis_scanfree.py:55 and :121"),
        "trellis_forward": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                            "cs304_tpu/ops/pallas/trellis_scanfree.py:55"),
        "trellis_backtrace": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                              "cs304_tpu/ops/pallas/trellis_scanfree.py:121"),
        "trellis_banded_decode": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                                  "cs304_tpu/ops/pallas/trellis_banded.py:41 and "
                                  "cs304_tpu/ops/pallas/trellis_scanfree.py:121"),
        "trellis_banded_forward": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                                   "cs304_tpu/ops/pallas/trellis_banded.py:41"),
        "trellis_dense_forward": ("cs304_tpu_torch/csrc/trellis_dense.cu",
                                  "cs304_tpu/ops/pallas/trellis.py:33"),
        # No Pallas counterpart: the JAX pool's step is a lax.scan.
        "trellis_stream": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                           "cs304_tpu/ops/streaming_batch.py:201 (lax.scan; also :130)"),
        # No Pallas counterpart: the JAX trainer's forward-backward is two
        # lax.scans.
        "trellis_fb": ("cs304_tpu_torch/csrc/trellis_fb.cu",
                       "cs304_tpu/models/train_fused.py:369 (_banded_fb_batch, lax.scans)"),
        # The E-step mode of the same kernel: the forward-backward and the
        # posteriors the JAX trainer forms from it.
        "trellis_fb_posteriors": ("cs304_tpu_torch/csrc/trellis_fb.cu",
                                  "cs304_tpu/models/train_fused.py:369 (_banded_fb_batch) "
                                  "and :663-715 (gamma_of, the xi loop)"),
        # No Pallas counterpart: the JAX package's DTW is a lax.scan.
        "dtw": ("cs304_tpu_torch/csrc/dtw.cu",
                "cs304_tpu/ops/dtw.py:47 (dtw_multi_template, lax.scan)"),
        # No Pallas counterpart: the JAX decoder runs bigram and beam
        # decoding on its banded lax.scan, and its bigram pool on the banded
        # step's lax.scan.
        "trellis_decode_lm": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                              "cs304_tpu/ops/viterbi.py:275 (viterbi_composite_batch_fast "
                              "with pair_penalty, lax.scan)"),
        "trellis_decode_beam": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                                "cs304_tpu/ops/viterbi.py:275 (viterbi_composite_batch_fast "
                                "with beam, lax.scan)"),
        "trellis_stream_lm": ("cs304_tpu_torch/csrc/trellis_scanfree.cu",
                              "cs304_tpu/ops/streaming_batch.py:97 (_banded_coeffs with lm) "
                              "and :201 (lax.scan)"),
        # No Pallas counterpart: the JAX package's constrained searches are
        # lax.scans; counted decoding is grammar decoding on a chain.
        "trellis_planes": ("cs304_tpu_torch/csrc/trellis_constrained.cu",
                           "cs304_tpu/ops/viterbi_counted.py:124 and "
                           "cs304_tpu/ops/grammar.py:237 (lax.scans)"),
        "trellis_duration": ("cs304_tpu_torch/csrc/trellis_constrained.cu",
                             "cs304_tpu/ops/viterbi_duration.py:145 (lax.scan)"),
        # No Pallas counterpart: the JAX package's posterior and n-best
        # searches are lax.scans.
        "lattice_sum": ("cs304_tpu_torch/csrc/trellis_lattice.cu",
                        "cs304_tpu/ops/lattice.py:312 (_sum_passes_masked, lax.scans :336, "
                        ":348; vmapped by :361)"),
        "lattice_max": ("cs304_tpu_torch/csrc/trellis_lattice.cu",
                        "cs304_tpu/ops/lattice.py:227 (_lattice_passes_impl, lax.scans :274, "
                        ":292)"),
        "kbest": ("cs304_tpu_torch/csrc/trellis_lattice.cu",
                  "cs304_tpu/ops/nbest.py:27 (kbest_composite_forward, lax.scan :124)"),
        # No Pallas counterpart: the JAX package's dense forward-backward is
        # two lax.scans.
        "fb_dense": ("cs304_tpu_torch/csrc/forward_backward.cu",
                     "cs304_tpu/ops/forward_backward.py:24 and :55 (forward / backward, "
                     "lax.scans :47, :75)"),
    }
    rows = []
    for name, (src, rep) in meta.items():
        library_ms, bound_ms, bound_by = yardsticks[name]
        # "poisons": the patterns every check of the kernel against its plain
        # version ran its outputs under (kernel_runs / stream_step_runs).
        poisons = [p for p in KERNEL_POISONS if p in POISONED.get(name, ())]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches[name], "max_abs_err": errs[name],
                     "ms": timings[name][0], "plain_ms": timings[name][1],
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                     "poisons": poisons})
    unpoisoned = [r["name"] for r in rows if r["poisons"] != list(KERNEL_POISONS)]
    if unpoisoned:
        raise SystemExit(f"no check ran these kernels under both poisons: {unpoisoned}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
