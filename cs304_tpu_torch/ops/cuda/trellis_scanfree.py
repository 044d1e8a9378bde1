"""Scan-free composite Viterbi: wrappers of the CUDA forward kernel (decode
and backpointer modes) and the backtrace kernel (csrc/trellis_scanfree.cu).

Replaces cs304_tpu/ops/pallas/trellis_scanfree.py (_forward_kernel,
_backtrace_kernel). The kernels are bitwise the plain version,
ops/viterbi.py:viterbi_composite_batch_fast (forward_fast + first_max +
backtrace_batch).

- scanfree_decode (the decoder's main path) is ONE launch of the forward in
  decode mode: forward, best exit and backtrace inside the kernel, with
  one-byte backpointer codes kept on chip (ops/viterbi.py:backpointer_codes
  is their plain specification).
- trellis_forward is the forward in backpointer mode: alpha and int32
  backpointers, for the K5/K6 wrappers and the tests.
- trellis_backtrace walks int32 backpointers: K4's backtrace.
- scanfree_decode_lm and scanfree_decode_beam are the search decode modes,
  one launch each: the bigram LM's per-word entry update (with or without
  the beam), and the beam on the flat penalty. They replace the JAX
  package's viterbi_composite_batch_fast with pair_penalty / beam
  (cs304_tpu/ops/viterbi.py:275), which its decoder runs on the banded scan;
  there is no Pallas kernel of them. Their plain version is the same
  function here (ops/viterbi.py; backpointer_codes(per_word=True) /
  backtrace_codes specify the LM mode's codes).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. The kernels take every B >= 1, T >= 1 and
S <= MAX_STATES, with no shape fallback; past MAX_STATES they raise.
log_b may carry padded state columns (the emission kernel's layout), which
are skipped through its row stride, at any 4-byte alignment.
"""
from __future__ import annotations

import functools

import torch

from ..viterbi import backtrace_batch, first_max, forward_fast, pack_coefs
from . import _build

# One team of at most 32 warps holds 8 states a lane; 8192 states keeps the
# JAX kernels' limit.
MAX_STATES = 8192

__all__ = [
    "MAX_STATES", "codes_scratch_bytes", "lm_table_branch", "pack_coefs", "scanfree_decode",
    "scanfree_decode_beam", "scanfree_decode_lm",
    "trellis_backtrace", "trellis_forward", "viterbi_composite_batch_scanfree",
]


def _check_cuda(name, t, dtype):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_forward(log_b, coefs, lengths):
    """Validate the forward's CUDA inputs -> (B, T, S, ld)."""
    b, t_total, ld = log_b.shape
    s = coefs.shape[1]
    _check_cuda("log_b", log_b, torch.float32)
    _check_cuda("coefs", coefs, torch.float32)
    _check_cuda("lengths", lengths, torch.int32)
    if coefs.shape[0] != 8 or not 1 <= s <= min(ld, MAX_STATES):
        raise ValueError(
            f"coefs {tuple(coefs.shape)} vs log_b {tuple(log_b.shape)}: need "
            f"(8, S) with 1 <= S <= min(log_b.shape[2], {MAX_STATES})"
        )
    if lengths.shape != (b,) or b < 1 or t_total < 1:
        raise ValueError(f"lengths {tuple(lengths.shape)} vs batch {b}, T {t_total}")
    if not (log_b.device == coefs.device == lengths.device):
        raise ValueError("log_b, coefs and lengths are on different devices")
    return b, t_total, s, ld


def _check_lm(lm, s):
    """Validate a bigram LM's CUDA operands (ops/viterbi.lm_tables) for S
    states -> W."""
    pair, word_of, uppers = lm
    _check_cuda("pair", pair, torch.float32)
    _check_cuda("word_of_state", word_of, torch.int32)
    _check_cuda("uppers", uppers, torch.int32)
    w = uppers.shape[0]
    if pair.shape != (w, w) or word_of.shape != (s,) or not 1 <= w <= s:
        raise ValueError(
            f"pair {tuple(pair.shape)}, word_of_state {tuple(word_of.shape)}, "
            f"uppers {tuple(uppers.shape)}: need (W, W), (S,), (W,) with 1 <= W <= S = {s}")
    return w


def trellis_forward(log_b, coefs, penalty, lengths):
    """log_b (B, T, ld >= S) float32, coefs (8, S) float32, penalty float,
    lengths (B,) int32 -> (alpha (B, S) float32, bp (B, T, S) int32)."""
    if not log_b.is_cuda:
        return forward_fast(log_b, coefs, penalty, lengths)
    b, t_total, s, ld = _check_forward(log_b, coefs, lengths)
    lib = _build.load()
    alpha = torch.empty((b, s), dtype=torch.float32, device=log_b.device)
    bp = torch.empty((b, t_total, s), dtype=torch.int32, device=log_b.device)
    with torch.cuda.device(log_b.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_forward(
            log_b.data_ptr(), coefs.data_ptr(), float(penalty),
            lengths.data_ptr(), alpha.data_ptr(), bp.data_ptr(),
            b, t_total, s, ld, stream,
        )
    _build.check(code, "trellis_forward")
    trellis_forward.launches += 1
    return alpha, bp


trellis_forward.launches = 0


def trellis_backtrace(bp, best, lengths, quirk: bool = True):
    """bp (B, T, S) int32 or int8, best (B,) int32 start states, lengths (B,)
    int32 -> paths (B, T) int32, the reference quirk applied when ``quirk``.
    bp may be a view whose (T, S) rows are contiguous but whose utterances
    lie further apart (the serving ring's ``ring[:, :T]``, walked in place).
    The kernel follows bp from best without bounds checks: best must lie in
    [0, S) and bp must come from a forward (or the ring) of these lengths."""
    if not bp.is_cuda:
        return backtrace_batch(bp, best, lengths, quirk)
    b, t_total, s = bp.shape
    if bp.dtype not in (torch.int32, torch.int8):
        raise TypeError(f"bp must be int32 or int8, got {bp.dtype}")
    if bp.stride(2) != 1 or (t_total > 1 and bp.stride(1) != s) or bp.stride(0) < t_total * s:
        raise ValueError(f"bp rows must be contiguous (strides {bp.stride()}, S {s})")
    _check_cuda("best", best, torch.int32)
    _check_cuda("lengths", lengths, torch.int32)
    if best.shape != (b,) or lengths.shape != (b,):
        raise ValueError(
            f"best {tuple(best.shape)} / lengths {tuple(lengths.shape)} vs batch {b}"
        )
    if not (bp.device == best.device == lengths.device):
        raise ValueError("bp, best and lengths are on different devices")
    lib = _build.load()
    path = torch.empty((b, t_total), dtype=torch.int32, device=bp.device)
    with torch.cuda.device(bp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_backtrace(
            bp.data_ptr(), bp.element_size(), bp.stride(0), best.data_ptr(),
            lengths.data_ptr(), path.data_ptr(), b, t_total, s, int(quirk), stream,
        )
    _build.check(code, "trellis_backtrace")
    trellis_backtrace.launches += 1
    return path


trellis_backtrace.launches = 0


@functools.lru_cache(maxsize=64)
def codes_scratch_bytes(b: int, t_total: int, s: int, n_words: int = 0) -> int:
    """Bytes of device scratch a decode mode allocates for its backpointer
    codes at this shape (n_words = W for the LM mode, which keeps W
    best-exit sources a step): 0 where they stay in shared memory. The
    kernel's launch plan decides; a shape asks it once."""
    return int(_build.load().cs304_trellis_decode_scratch_bytes(b, t_total, s, n_words))


@functools.lru_cache(maxsize=64)
def lm_table_branch(t_total: int, s: int, n_words: int, decode: bool = True) -> str:
    """Where an LM mode reads its (W, W) pair table at this shape, as the
    kernel's launch plan decides: "registers" (each lane's column for the
    whole launch: a one-warp team, S <= 64, at W <= 32, in both modes),
    "shared" (a decode mode's table and uppers staged into shared memory
    once a block, where they fit after its codes, which keep their branch)
    or "global" (through the read-only cache)."""
    lib = _build.load()
    return ("global", "shared", "registers")[
        lib.cs304_trellis_lm_table(t_total, s, n_words, int(decode))]


def scanfree_decode(log_b, coefs, penalty, lengths, quirk_backtrace: bool = True):
    """Forward + best exit + backtrace on packed coefficients: log_b
    (B, T, ld >= S) float32 (padded state columns past S = coefs.shape[1]
    are ignored), coefs (8, S), lengths (B,) int32 -> (scores (B,) float32,
    paths (B, T) int32). On CUDA tensors one launch of the decode-mode
    kernel."""
    if not log_b.is_cuda:
        return _plain_search(log_b, coefs, penalty, lengths, quirk_backtrace)
    b, t_total, s, ld = _check_forward(log_b, coefs, lengths)
    lib = _build.load()
    dev = log_b.device
    scores = torch.empty((b,), dtype=torch.float32, device=dev)
    paths = torch.empty((b, t_total), dtype=torch.int32, device=dev)
    n_scratch = codes_scratch_bytes(b, t_total, s)
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=dev) if n_scratch else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_decode(
            log_b.data_ptr(), coefs.data_ptr(), float(penalty), lengths.data_ptr(),
            scores.data_ptr(), paths.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            b, t_total, s, ld, int(quirk_backtrace), stream,
        )
    _build.check(code, "scanfree_decode")
    scanfree_decode.launches += 1
    return scores, paths


scanfree_decode.launches = 0


def _plain_search(log_b, coefs, penalty, lengths, quirk, lm=None, beam=None):
    """The decode modes' plain version: forward_fast, first_max over the
    exits, backtrace_batch."""
    alpha, bp = forward_fast(log_b, coefs, penalty, lengths, lm=lm, beam=beam)
    scores, best = first_max(alpha, coefs[5] > 0)
    return scores, backtrace_batch(bp, best, lengths, quirk)


def _search_launch(what, log_b, coefs, penalty, lengths, quirk, lm, beam):
    b, t_total, s, ld = _check_forward(log_b, coefs, lengths)
    w = _check_lm(lm, s) if lm is not None else 0
    pair, word_of, uppers = lm if lm is not None else (None, None, None)
    if lm is not None and pair.device != log_b.device:
        raise ValueError("the LM tables and log_b are on different devices")
    lib = _build.load()
    dev = log_b.device
    scores = torch.empty((b,), dtype=torch.float32, device=dev)
    paths = torch.empty((b, t_total), dtype=torch.int32, device=dev)
    n_scratch = codes_scratch_bytes(b, t_total, s, w)
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=dev) if n_scratch else None
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_search_decode(
            log_b.data_ptr(), coefs.data_ptr(), float(penalty), ptr(pair), ptr(word_of),
            ptr(uppers), w, float(beam) if beam is not None else 0.0, int(beam is not None),
            lengths.data_ptr(), scores.data_ptr(), paths.data_ptr(), ptr(scratch),
            b, t_total, s, ld, int(quirk), stream,
        )
    _build.check(code, what)
    return scores, paths


def scanfree_decode_lm(log_b, coefs, lm, lengths, beam=None, quirk_backtrace: bool = True):
    """The LM decode mode (with the beam when ``beam`` is given): log_b
    (B, T, ld >= S) float32, coefs (8, S), lm = ops/viterbi.lm_tables'
    (pair (W, W) float32, word_of_state (S,) int32, uppers (W,) int32),
    lengths (B,) int32 -> (scores (B,), paths (B, T) int32). One launch on
    CUDA tensors; the plain version (forward_fast(lm=, beam=)) on the CPU."""
    if not log_b.is_cuda:
        return _plain_search(log_b, coefs, 0.0, lengths, quirk_backtrace, lm=lm, beam=beam)
    out = _search_launch("scanfree_decode_lm", log_b, coefs, 0.0, lengths, quirk_backtrace,
                         lm, beam)
    scanfree_decode_lm.launches += 1
    return out


scanfree_decode_lm.launches = 0


def scanfree_decode_beam(log_b, coefs, penalty, lengths, beam, quirk_backtrace: bool = True):
    """The BEAM decode mode on the flat penalty: scanfree_decode's
    arguments and the beam -> (scores (B,), paths (B, T) int32). One launch
    on CUDA tensors; the plain version (forward_fast(beam=)) on the CPU."""
    if not log_b.is_cuda:
        return _plain_search(log_b, coefs, penalty, lengths, quirk_backtrace, beam=beam)
    out = _search_launch("scanfree_decode_beam", log_b, coefs, penalty, lengths,
                         quirk_backtrace, None, beam)
    scanfree_decode_beam.launches += 1
    return out


scanfree_decode_beam.launches = 0


def viterbi_composite_batch_scanfree(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
    quirk_backtrace: bool = True,
):
    """Drop-in for viterbi_composite_batch_fast: log_b (B, T, S) float32,
    lengths (B,) -> (scores (B,), paths (B, T) int32)."""
    dev = log_b.device
    coefs = pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return scanfree_decode(log_b.contiguous(), coefs, penalty, lengths,
                           quirk_backtrace)
