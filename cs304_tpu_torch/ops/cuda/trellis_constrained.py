"""Constrained composite Viterbi: wrappers of the PLANES and DURATION
kernels (csrc/trellis_constrained.cu) and their host tables.

- planes_decode is counted and grammar decoding: the (G, S) trellis of a
  word automaton's planes x composite states, the cross move routed
  through next_state. It replaces the JAX package's lax.scans of
  cs304_tpu/ops/grammar.py:237 and cs304_tpu/ops/viterbi_counted.py:124
  (counted decoding is the chain automaton of
  ops/viterbi_counted.chain_grammar). Plain version:
  ops/grammar.viterbi_composite_grammar_batch_plain.
- duration_decode is the (S, D) state-duration lattice, replacing the
  lax.scan of cs304_tpu/ops/viterbi_duration.py:145. Plain version:
  ops/viterbi_duration.viterbi_composite_duration_batch_plain.

Each wrapper builds its tables on the host once a call (stay and advance
coefficients from the composite's band, the routing table, the duration
masks), uploads them in one float and one int32 buffer and launches the
kernel once: its team branches (planes_plan / duration_plan) write one
byte a (step, cell) and walk them back in the same launch, returning scores
and paths. Shapes past the teams (planes_plan's and duration_plan's
"simple" branch) take the plane-product / duration-lattice kernel of int32
backpointers over the cells, walked by K2-bt
(trellis_scanfree.trellis_backtrace), or past the widest row K2-bt stages
(k2bt_max_cells, which the library reports) by that forward itself.
Scores are bitwise the plain version's, paths wherever the score is finite
(ROADMAP W3: at -inf cells the plain argmax points at index 0). The
wrappers take CUDA tensors only: the dispatchers in ops/viterbi_counted,
ops/grammar and ops/viterbi_duration send a CPU log_b to the plain
versions.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .trellis_scanfree import trellis_backtrace

UNBOUNDED = np.int32(2**30)  # max_dur sentinel: no upper duration limit

__all__ = ["UNBOUNDED", "DeviceTables", "duration_decode", "duration_forward",
           "duration_operands", "duration_plan", "duration_tables", "duration_upload",
           "forward_branch", "k2bt_max_cells", "planes_decode", "planes_forward",
           "planes_operands", "planes_plan", "planes_tables", "planes_upload", "routing_table",
           "stay_coefs", "team_instance", "walk_of"]


def _host(x, dtype=None):
    """x (array-like or tensor on any device) as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _band(log_a, lower_of_state, k):
    """(S,) log_a[j - k, j] where j - k lies on state j's band (j - k >= 0
    and >= the word's entry), else -inf."""
    s = log_a.shape[0]
    j = np.arange(s)
    i = j - k
    ok = (i >= 0) & (i >= lower_of_state)
    out = np.full(s, -np.inf, np.float32)
    out[ok] = log_a[i[ok], j[ok]]
    return out


def _diag_init(diag):
    """The degenerate-safe t = 0 self-loop (ops/viterbi_counted._topology)."""
    return np.where(np.isfinite(diag), diag, np.float32(0.0)).astype(np.float32)


def stay_coefs(log_a, lower_of_state, is_entry):
    """(3, S) float32, rows c2, c1, c0: the stay move into state j from
    j - 2, j - 1 and j, as ops/viterbi_counted._stay_matrix holds them (the
    banded within-word moves; an entry state's self-loop alone), -inf off
    that band."""
    log_a = _host(log_a, np.float32)
    lower = _host(lower_of_state, np.int64)
    entry = _host(is_entry).astype(bool)
    out = np.stack([_band(log_a, lower, k) for k in (2, 1, 0)])
    out[:2, entry] = -np.inf
    out[2, entry] = np.diagonal(log_a)[entry]
    return out


def routing_table(next_state):
    """The cross move's sources: row g * W + w lists the planes g' with
    next_state[g', w] == g, ascending (the planes ops/grammar's ``route``
    selects) -> (offsets (G * W + 1,) int32, sources int32)."""
    ns = _host(next_state, np.int64)
    g, w = ns.shape
    src, word = np.nonzero(ns >= 0)  # row-major: ascending source plane
    key = ns[src, word] * w + word
    order = np.argsort(key, kind="stable")
    offsets = np.zeros(g * w + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=g * w), out=offsets[1:])
    return offsets.astype(np.int32), src[order].astype(np.int32)


def planes_tables(log_a, lower_of_state, is_entry, is_exit, word_of_state, next_state,
                  accept):
    """The PLANES kernel's host tables: ftab (4, S) float32 (stay_coefs'
    rows, then the t = 0 self-loop a0) and the int32 pieces itab (2, S)
    (each entry's word, -1 elsewhere; the plane its t = 0 seed lies in, -1
    for none), exits (ascending), the routing table's offsets and sources,
    and accept (G,)."""
    log_a = _host(log_a, np.float32)
    entry = _host(is_entry).astype(bool)
    word = _host(word_of_state, np.int64)
    ns = _host(next_state, np.int64)
    acc = _host(accept).astype(bool)
    s = log_a.shape[0]
    if ns.ndim != 2 or ns.shape[0] < 1 or ns.shape[1] < 1:
        raise ValueError(f"next_state must be (G, W) with G, W >= 1, got {ns.shape}")
    g, w = ns.shape
    if ns.min() < -1 or ns.max() >= g:
        raise ValueError(f"next_state holds planes outside [-1, {g})")
    if word.shape != (s,) or acc.shape != (g,):
        raise ValueError(f"word_of_state {word.shape} / accept {acc.shape} vs S={s}, G={g}")
    if ((word[entry] < 0) | (word[entry] >= w)).any():
        raise ValueError(f"an entry state's word lies outside [0, {w})")
    entry_word = np.where(entry, word, -1)
    seed = np.where(entry, ns[0][np.where(entry, word, 0)], -1)
    ftab = np.concatenate([stay_coefs(log_a, lower_of_state, entry),
                           _diag_init(np.diagonal(log_a))[None]])
    offsets, sources = routing_table(ns)
    return ftab, {"itab": np.stack([entry_word, seed]).astype(np.int32),
                  "exits": np.nonzero(_host(is_exit).astype(bool))[0].astype(np.int32),
                  "route_off": offsets, "route_src": sources,
                  "accept": acc.astype(np.int32)}


def duration_tables(log_a, lower_of_state, is_entry, is_exit, min_dur, max_dur):
    """The DURATION kernel's host tables: ftab (4, S) float32 (the advance
    into a non-entry j from j - 2 and j - 1, log_a[i, j] on the band as
    ops/viterbi.composite_transition_matrix holds it, -inf elsewhere and at
    the entries; the stay's log_a[s, s]; the t = 0 self-loop a0) and the
    int32 pieces itab (3, S) (flags: 1 entry, 2 exit, 4 unbounded max_dur;
    min_dur; max_dur) and exits (ascending)."""
    log_a = _host(log_a, np.float32)
    lower = _host(lower_of_state, np.int64)
    entry = _host(is_entry).astype(bool)
    exit_ = _host(is_exit).astype(bool)
    lo = _host(min_dur, np.int64)
    hi = _host(max_dur, np.int64)
    s = log_a.shape[0]
    if lo.shape != (s,) or hi.shape != (s,):
        raise ValueError(f"min_dur {lo.shape} / max_dur {hi.shape} vs S={s}")
    adv = np.stack([_band(log_a, lower, k) for k in (2, 1)])
    adv[:, entry] = -np.inf
    diag = np.diagonal(log_a).astype(np.float32)
    ftab = np.concatenate([adv, diag[None], _diag_init(diag)[None]])
    flags = entry * 1 + exit_ * 2 + (hi >= int(UNBOUNDED)) * 4
    i32 = np.iinfo(np.int32)
    itab = np.stack([flags, np.clip(lo, i32.min, i32.max), np.clip(hi, i32.min, i32.max)])
    return ftab, {"itab": itab.astype(np.int32),
                  "exits": np.nonzero(exit_)[0].astype(np.int32)}


def _need_cuda(log_b):
    if not log_b.is_cuda:
        raise ValueError(f"log_b must be a CUDA tensor, got {log_b.device}")


def _rows(log_b):
    """log_b (B, T, S) float32 on the card -> (log_b, B, T, S, ld): state j
    of frame t of utterance b at (b * T + t) * ld + j. A column slice of a
    padded (B, T, ld) tensor is read in place; another layout is copied."""
    _need_cuda(log_b)
    if log_b.dtype != torch.float32:
        raise TypeError(f"log_b must be torch.float32, got {log_b.dtype}")
    if log_b.dim() != 3 or min(log_b.shape) < 1:
        raise ValueError(f"log_b must be (B, T, S) with B, T, S >= 1, got {tuple(log_b.shape)}")
    b, t_total, s = log_b.shape
    if t_total > 1:
        ld = log_b.stride(1)
    else:
        ld = log_b.stride(0) if b > 1 else s
    if not ((s == 1 or log_b.stride(2) == 1) and ld >= s
            and (b == 1 or log_b.stride(0) == t_total * ld)):
        log_b, ld = log_b.contiguous(), s
    return log_b, b, t_total, s, ld


@dataclass(frozen=True)
class DeviceTables:
    """A kernel's host tables on the card: the float buffer ftab, the int32
    buffer ints and each int piece's address in it (ptrs), for S states
    and ``depth`` planes (PLANES: G, with W words) or slots (DURATION: D,
    W = 0); entry_exit: some entry state is also an exit (DURATION's team
    then keeps the best two exit sums a step)."""
    ftab: torch.Tensor
    ints: torch.Tensor
    ptrs: dict
    s: int
    depth: int
    words: int
    n_exit: int
    entry_exit: bool = False


def _upload(dev, ftab, ints, depth, words, entry_exit=False):
    """One float and one int32 buffer on dev -> DeviceTables."""
    dev = torch.device(dev)
    ftab_d = torch.as_tensor(np.ascontiguousarray(ftab, np.float32)).to(dev)
    flat = np.concatenate([np.ravel(v).astype(np.int32) for v in ints.values()] +
                          [np.zeros(1, np.int32)])
    ints_d = torch.as_tensor(flat).to(dev)
    ptrs, off = {}, 0
    for name, v in ints.items():
        ptrs[name] = ints_d.data_ptr() + 4 * off
        off += np.size(v)
    return DeviceTables(ftab_d, ints_d, ptrs, ftab.shape[1], depth, words, len(ints["exits"]),
                        bool(entry_exit))


def planes_upload(ftab, ints, device) -> DeviceTables:
    """planes_tables' (ftab, ints) on device."""
    g = len(ints["accept"])
    return _upload(device, ftab, ints, g, (len(ints["route_off"]) - 1) // g)


def duration_upload(ftab, ints, d_cap, device) -> DeviceTables:
    """duration_tables' (ftab, ints) on device, for d_cap slots."""
    if int(d_cap) < 1:
        raise ValueError(f"d_cap must be >= 1, got {d_cap}")
    return _upload(device, ftab, ints, int(d_cap), 0, ((ints["itab"][0] & 3) == 3).any())


def planes_operands(log_a, lower_of_state, is_entry, is_exit, word_of_state, next_state,
                    accept, device) -> DeviceTables:
    """planes_tables uploaded to device."""
    return planes_upload(*planes_tables(log_a, lower_of_state, is_entry, is_exit, word_of_state,
                                        next_state, accept), device)


def duration_operands(log_a, lower_of_state, is_entry, is_exit, min_dur, max_dur, d_cap,
                      device) -> DeviceTables:
    """duration_tables uploaded to device, for d_cap slots."""
    return duration_upload(*duration_tables(log_a, lower_of_state, is_entry, is_exit, min_dur,
                                            max_dur), d_cap, device)


BRANCHES = ("team", "cluster", "simple")


@functools.lru_cache(maxsize=256)
def _plan(planes: bool, t: int, s: int, depth: int) -> dict:
    out = (ctypes.c_int * 7)()
    lib = _build.load()
    fn = lib.cs304_trellis_planes_plan if planes else lib.cs304_trellis_duration_plan
    _build.check(fn(t, s, depth, out), fn.__name__)
    return {"branch": BRANCHES[out[0]], "codes": "shared" if out[1] else "global",
            "k": out[2], "warps": out[3], ("ctas" if planes else "teams"): out[4],
            "threads": out[5], "stage_rows": out[6]}


def planes_plan(t: int, s: int, g: int) -> dict:
    """PLANES' launch plan at T steps, S states and G planes: the branch
    ("team": one CTA an utterance; "cluster": a cluster of CTAs; "simple":
    the plane-product kernel of int32 backpointers and K2-bt, for G > 64,
    S > 32,767 or planes past what eight CTAs hold), where its codes live,
    states a lane, warps a plane, CTAs an utterance, threads a CTA, and the
    rows of global codes the walk stages at a time in shared memory (0:
    it reads them in place)."""
    return _plan(True, t, s, g)


def duration_plan(t: int, s: int, d: int) -> dict:
    """DURATION's launch plan at T steps, S states and D slots: the branch
    ("team", or "simple" past 8 slots or 20 warps of 8 states), where its
    codes live, states a lane, warps a team, teams a block, threads a
    block, and the rows the walk stages (as planes_plan)."""
    return _plan(False, t, s, d)


@functools.lru_cache(maxsize=256)
def _instance(planes: bool, t: int, s: int, depth: int, penalty: float, entry_exit: bool):
    out = (ctypes.c_int * 4)()
    code = _build.load().cs304_trellis_team_instance(int(planes), t, s, depth, penalty,
                                                     int(entry_exit), out)
    return None if code < 0 else tuple(out)


def team_instance(planes: bool, tabs, t: int, penalty) -> tuple | None:
    """The template arguments of the team kernel a launch on tabs at T steps
    and penalty takes, as the library decides them: PLANES (K, CLUSTERED,
    KEY, 0), DURATION (K, DM, SLOTS_SMEM, TWO); None on the simple branch."""
    return _instance(bool(planes), int(t), tabs.s, tabs.depth, float(penalty),
                     bool(tabs.entry_exit))


@functools.lru_cache(maxsize=64)
def planes_scratch_bytes(b: int, t: int, s: int, g: int, w: int, simple: bool = False) -> int:
    """Bytes of global scratch a PLANES launch needs at this shape: 0 where
    the team's codes (the simple branch's alpha buffers and step tables)
    fit in shared memory."""
    return int(_build.load().cs304_trellis_planes_scratch_bytes(b, t, s, g, w, int(simple)))


@functools.lru_cache(maxsize=64)
def duration_scratch_bytes(b: int, t: int, s: int, d: int, simple: bool = False) -> int:
    """planes_scratch_bytes for the DURATION kernel."""
    return int(_build.load().cs304_trellis_duration_scratch_bytes(b, t, s, d, int(simple)))


@functools.lru_cache(maxsize=8)
def _k2bt_max_states(index: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        code = _build.load().cs304_trellis_backtrace_max_states(4, ctypes.addressof(out))
    _build.check(code, "trellis_backtrace_max_states")
    return out.value


def k2bt_max_cells(device) -> int:
    """The widest row of int32 backpointers K2-bt walks on device (its two
    tile buffers in the shared memory a block may opt into there); past it
    the simple branch's forward walks the path itself."""
    index = torch.device(device).index
    return _k2bt_max_states(torch.cuda.current_device() if index is None else index)


def walk_of(planes: bool, tabs, t: int, device) -> str:
    """Who walks a decode's path: "kernel" (the team branches walk their
    codes), "k2bt" or "forward" (the simple branch: K2-bt over its int32
    backpointers, or its forward past K2-bt's widest row)."""
    plan = (planes_plan if planes else duration_plan)(t, tabs.s, tabs.depth)
    if plan["branch"] != "simple":
        return "kernel"
    return "forward" if tabs.s * tabs.depth > k2bt_max_cells(device) else "k2bt"


def forward_branch(planes, log_b, tabs, penalty, lengths, quirk=True, simple=False):
    """One launch of PLANES (planes=True) or DURATION on tabs -> (scores
    (B,), paths (B, T) int32 states). The team branches walk their codes in
    the launch; the simple branch (its plan's, or forced by simple=True, as
    a timing compares the two) writes int32 backpointers over the cells and
    walks them with K2-bt, or in its forward past K2-bt's widest row."""
    log_b, b, t_total, s, ld = _rows(log_b)
    if tabs.s != s or tabs.ftab.device != log_b.device:
        raise ValueError(f"tables for {tabs.s} states on {tabs.ftab.device}, log_b for {s} "
                         f"on {log_b.device}")
    dev = log_b.device
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} vs batch {b}")
    plan = (planes_plan if planes else duration_plan)(t_total, s, tabs.depth)
    simple = simple or plan["branch"] == "simple"
    lib = _build.load()
    scores = torch.empty((b,), dtype=torch.float32, device=dev)
    n_scratch = (planes_scratch_bytes(b, t_total, s, tabs.depth, tabs.words, simple) if planes
                 else duration_scratch_bytes(b, t_total, s, tabs.depth, simple))
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=dev) if n_scratch else None
    p = tabs.ptrs
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    fn = planes_decode if planes else duration_decode
    if not simple:
        paths = torch.empty((b, t_total), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if planes:
                code = lib.cs304_trellis_planes_team(
                    log_b.data_ptr(), lengths.data_ptr(), tabs.ftab.data_ptr(), p["itab"],
                    p["exits"], p["route_off"], p["route_src"], p["accept"], float(penalty),
                    b, t_total, s, ld, tabs.depth, tabs.words, tabs.n_exit, scores.data_ptr(),
                    paths.data_ptr(), int(quirk), ptr(scratch), stream)
            else:
                code = lib.cs304_trellis_duration_team(
                    log_b.data_ptr(), lengths.data_ptr(), tabs.ftab.data_ptr(), p["itab"],
                    float(penalty), b, t_total, s, ld, tabs.depth, int(tabs.entry_exit),
                    scores.data_ptr(), paths.data_ptr(), int(quirk), ptr(scratch), stream)
        _build.check(code, fn.__name__)
        fn.launches += 1
        return scores, paths
    cells = s * tabs.depth
    start = torch.empty((b,), dtype=torch.int32, device=dev)
    bps = torch.empty((b, t_total, cells), dtype=torch.int32, device=dev)
    # Past K2-bt's widest row the forward walks the path itself.
    path = (torch.empty((b, t_total), dtype=torch.int32, device=dev)
            if cells > k2bt_max_cells(dev) else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if planes:
            code = lib.cs304_trellis_planes(
                log_b.data_ptr(), lengths.data_ptr(), tabs.ftab.data_ptr(), p["itab"],
                p["exits"], p["route_off"], p["route_src"], p["accept"], float(penalty),
                b, t_total, s, ld, tabs.depth, tabs.words, tabs.n_exit, scores.data_ptr(),
                start.data_ptr(), bps.data_ptr(), ptr(path), int(quirk), ptr(scratch), stream)
        else:
            code = lib.cs304_trellis_duration(
                log_b.data_ptr(), lengths.data_ptr(), tabs.ftab.data_ptr(), p["itab"],
                p["exits"], float(penalty), b, t_total, s, ld, tabs.depth, tabs.n_exit,
                scores.data_ptr(), start.data_ptr(), bps.data_ptr(), ptr(path), int(quirk),
                ptr(scratch), stream)
    _build.check(code, fn.__name__)
    fn.launches += 1
    if path is None:
        path = trellis_backtrace(bps, start, lengths, quirk)
    return scores, (path % s if planes else torch.div(path, tabs.depth, rounding_mode="floor"))


def planes_forward(log_b, tabs, penalty, lengths, quirk_backtrace: bool = True):
    """The PLANES kernel on planes_operands' tables: log_b (B, T, S) float32
    on the card -> (scores (B,), paths (B, T) int32)."""
    return forward_branch(True, log_b, tabs, penalty, lengths, quirk_backtrace)


def duration_forward(log_b, tabs, penalty, lengths, quirk_backtrace: bool = True):
    """The DURATION kernel on duration_operands' tables."""
    return forward_branch(False, log_b, tabs, penalty, lengths, quirk_backtrace)


def planes_decode(log_b, log_a, lower_of_state, is_entry, is_exit, word_of_state,
                  next_state, accept, penalty, lengths, quirk_backtrace: bool = True):
    """Grammar (and counted) decoding: viterbi_composite_grammar_batch's
    arguments, log_b on the card -> (scores (B,) float32, paths (B, T)
    int32): one launch of the PLANES kernel (counted in
    planes_decode.launches), which walks the path itself (the simple
    branch: and one of K2-bt)."""
    _need_cuda(log_b)
    tabs = planes_operands(log_a, lower_of_state, is_entry, is_exit, word_of_state,
                           next_state, accept, log_b.device)
    return planes_forward(log_b, tabs, penalty, lengths, quirk_backtrace)


planes_decode.launches = 0


def duration_decode(log_b, log_a, lower_of_state, is_entry, is_exit, penalty, min_dur,
                    max_dur, lengths, d_cap: int = 8, quirk_backtrace: bool = True):
    """Duration decoding: viterbi_composite_duration_batch's arguments ->
    (scores (B,) float32, paths (B, T) int32), log_b on the card: one launch
    of the DURATION kernel (counted in duration_decode.launches), which
    walks the path itself (the simple branch: and one of K2-bt)."""
    _need_cuda(log_b)
    tabs = duration_operands(log_a, lower_of_state, is_entry, is_exit, min_dur, max_dur,
                             d_cap, log_b.device)
    return duration_forward(log_b, tabs, penalty, lengths, quirk_backtrace)


duration_decode.launches = 0
