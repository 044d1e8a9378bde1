"""Data-parallel training and decoding over ranks (torch.distributed).

A port of cs304_tpu/parallel/data_parallel.py. The reference's only
parallelism is a process pool fanning out per-utterance Viterbi alignments,
parameters shipped by fork/pickle and results gathered in the parent
(hidden_markov_model.py:300-305, 746-750; SURVEY.md §2.4). The JAX package
shards the utterance batch over a mesh's data axis with shard_map and sums
each E-step statistic with one psum. Here the mesh is a one-dimensional
``torch.distributed`` DeviceMesh named "data", one process a rank, and the
code is SPMD: every rank calls the same function with the same full inputs,
computes on its own contiguous block of rows (the block ``P("data")`` gives a
device), and the collectives leave every replicated output bitwise identical
on every rank.

The sum is not an all-reduce. NCCL's ring adds the chunks of a tensor in an
order that depends on where each chunk falls, so two ranks could hold
parameters an ulp apart, take different convergence decisions, stop at
different iterations and deadlock in the next collective. ``mesh_sum``
gathers every rank's statistic and adds the parts in rank order instead: the
same additions on every rank. Integer statistics are summed as integers. The
statistics are small: at the flagship the largest, the second moments of 60
slots, is 60 x 39 x 39 float32 (~365 KB).

Model parallelism is absent, as in the JAX package: the parameters (~350 KB
at the flagship) are replicated on every rank.
"""
from __future__ import annotations

import functools
import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import fp32_exact, resolve_device
from ..ops.cuda.trellis_dense import viterbi_composite_batch_pallas
from ..ops.gaussian import gaussian_log_pdf, make_gaussian_params
from ..ops.viterbi import viterbi_banded_batch

DATA_AXIS = "data"


def _rank_device(device_type: str, devices, rank: int, world: int) -> torch.device:
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices given for a {world}-rank group")
        return devices[rank]
    if device_type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(devices: Sequence | None = None, device_type: str | None = None) -> DeviceMesh:
    """1-D data-parallel mesh, named "data", over every rank of the default
    process group.

    The group is the default one when it exists; else one made from
    torchrun's RANK / WORLD_SIZE (and MASTER_ADDR / MASTER_PORT); else a
    1-rank group of this process alone, the counterpart of the JAX
    make_mesh() over one local device. A group made here has the backend
    nccl for "cuda" and gloo for "cpu".

    devices: optional per-rank devices, ``devices[r]`` for rank r (two gloo
    ranks may share one card). By default rank r runs on cuda:LOCAL_RANK, or
    on the CPU. device_type defaults to the devices' type, else "cuda",
    which raises without a card, as device.resolve_device does.

    This rank's device becomes the current CUDA device; every ``mesh=``
    site runs on it (mesh_device)."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        types = {d.type for d in devices}
        if len(types) != 1 or (device_type is not None and types != {device_type}):
            raise ValueError(f"devices {devices} are not all of type {device_type or 'one'}")
        device_type = types.pop()
    device_type = device_type or "cuda"
    resolve_device(device_type)  # no card: raises; another type: ValueError
    from_env = not dist.is_initialized() and "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    elif from_env:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        rank, world = 0, 1
    dev = _rank_device(device_type, devices, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before the communicator is made
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if from_env:
            dist.init_process_group(backend)
        else:
            # One rank: an in-process store, nothing written to disk.
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (world,), mesh_dim_names=(DATA_AXIS,))


def check_mesh(mesh) -> DeviceMesh:
    """mesh, if it is a 1-D DeviceMesh whose axis is named "data"; else
    TypeError."""
    if not (isinstance(mesh, DeviceMesh) and mesh.ndim == 1
            and mesh.mesh_dim_names == (DATA_AXIS,)):
        raise TypeError(
            f"mesh must be a 1-D torch DeviceMesh with the axis {DATA_AXIS!r} "
            f"(parallel.data_parallel.make_mesh), not {type(mesh).__name__}")
    return mesh


def mesh_size(mesh) -> int:
    return check_mesh(mesh).size()


def mesh_rank(mesh) -> int:
    return check_mesh(mesh).get_local_rank(DATA_AXIS)


def mesh_device(mesh) -> torch.device:
    """This rank's device: the CPU, or the current CUDA device, which
    make_mesh set."""
    if check_mesh(mesh).device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def site_device(mesh, device=None) -> torch.device:
    """The device of a ``mesh=`` site: the mesh's, which an explicit
    ``device`` must name (ValueError otherwise; "cuda" with no index names
    the current card)."""
    dev = mesh_device(mesh)
    if device is not None and device != "auto":
        want = torch.device(device)
        if want.type != dev.type or (want.index is not None and want.index != dev.index):
            raise ValueError(f"device={str(want)!r} disagrees with rank "
                             f"{mesh_rank(mesh)}'s mesh device {str(dev)!r}")
    return dev


def _all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """(w, *x.shape): every rank's x in rank order, on x's device (nccl and
    gloo both take CUDA tensors; gloo stages them through host memory)."""
    flat = x.contiguous().reshape(-1)
    parts = [torch.empty_like(flat) for _ in range(mesh.size())]
    dist.all_gather(parts, flat, group=mesh.get_group(DATA_AXIS))
    return torch.stack(parts).reshape(len(parts), *x.shape)


def mesh_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of x over the ranks, added in rank order, ((x0 + x1) + x2)
    + ...: bitwise the same on every rank, and x itself on one rank."""
    parts = _all_gather(x, mesh)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def reducer(mesh):
    """The ``reduce_fn`` of the trainers' iteration bodies over mesh."""
    return functools.partial(mesh_sum, mesh=check_mesh(mesh))


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous block of x's leading axis, as P("data") splits
    it; the axis must divide over the ranks (ValueError)."""
    w, r = mesh_size(mesh), mesh_rank(mesh)
    n = x.shape[0]
    if n % w:
        raise ValueError(f"leading axis of {n} does not divide over the {w}-rank mesh")
    k = n // w
    return x[r * k: (r + 1) * k]


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's block of rows, concatenated in rank order."""
    return _all_gather(x, mesh).reshape(-1, *x.shape[1:])


def _local_kmeans_stats(means, covs, log_a, batch, lengths, num_states: int):
    """One rank's E-step statistics: integer counts (S,) and transition
    counts (S, S), frame sums (S, D) and second moments (S, D, D) centred on
    the PREVIOUS means, gathered per frame along the Viterbi path. Centring
    first keeps every accumulated term small, so one sum over the ranks
    suffices without the cancellation of the raw one-pass form."""
    fp32_exact()
    s = num_states
    b, t, d = batch.shape
    dev = batch.device
    log_b = gaussian_log_pdf(make_gaussian_params(means, covs, device=dev), batch)
    _scores, paths = viterbi_banded_batch(log_b, log_a, lengths)
    path_l = paths.to(torch.int64)
    mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    counts = torch.bincount(torch.where(mask, path_l, s).reshape(-1), minlength=s + 1)[:s]
    oh = torch.nn.functional.one_hot(path_l, s).to(torch.float32) * mask[..., None]
    centered = batch - means[path_l]  # (B, T, D), small residuals
    c_sums = oh.reshape(b * t, s).T @ centered.reshape(b * t, d)
    weighted = (oh[..., :, None] * centered[..., None, :]).reshape(b * t, s * d)
    c_m2 = (weighted.T @ centered.reshape(b * t, d)).reshape(s, d, d)
    pair = torch.arange(t - 1, device=dev)[None, :] < (lengths[:, None] - 1)
    frm = path_l[:, :-1] * s + path_l[:, 1:]
    trans = torch.bincount(torch.where(pair, frm, s * s).reshape(-1),
                           minlength=s * s + 1)[: s * s].reshape(s, s)
    return counts, c_sums, c_m2, trans


def dp_kmeans_step(means, covs, log_a, batch, lengths, mesh, num_states: int,
                   cov_reg: float = 0.001):
    """One data-parallel segmental k-means iteration.

    batch (B, T, D) and lengths (B,) are every rank's full inputs; each rank
    aligns its block of rows, the four statistics are summed over the ranks,
    and the (tiny) M-step runs replicated. B must divide over the ranks.
    Returns (new_means, new_covs, new_log_a, counts) on the mesh device.

    The covariance recentres the moments taken around the previous means
    (_local_kmeans_stats); the single-device trainer (models/train_kmeans)
    keeps the two-pass np.cov form."""
    dev = mesh_device(mesh)
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=dev)
    means, covs, log_a, batch = f32(means), f32(covs), f32(log_a), f32(batch)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    counts, c_sums, c_m2, trans = _local_kmeans_stats(
        means, covs, log_a, shard_rows(batch, mesh), shard_rows(lengths, mesh), num_states)
    counts = mesh_sum(counts, mesh).to(torch.float32)
    c_sums = mesh_sum(c_sums, mesh)
    c_m2 = mesh_sum(c_m2, mesh)
    trans = mesh_sum(trans, mesh).to(torch.float32)

    delta = c_sums / torch.clamp(counts, min=1.0)[:, None]  # new mean - previous
    new_means = means + delta
    # sum (x - mu_new)(x - mu_new)^T = c_m2 - counts * delta delta^T
    m2_new = c_m2 - counts[:, None, None] * (delta[:, :, None] * delta[:, None, :])
    denom = torch.clamp(counts - 1.0, min=1.0)
    eye = torch.eye(batch.shape[-1], dtype=torch.float32, device=dev)
    new_covs = m2_new / denom[:, None, None] + cov_reg * eye
    probs = trans / torch.clamp(trans.sum(dim=1, keepdim=True), min=1.0)
    new_log_a = torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-38)),
                            torch.full_like(probs, float("-inf")))
    return new_means, new_covs, new_log_a, counts


def dp_embedded_stats(
    means_sent, covs_sent, log_a_sent, lab_of_state, loc_of_state, pos_of_state,
    batch, lengths, mesh, num_labels: int, s_max: int,
):
    """Data-parallel embedded-training statistics for one transcript's batch:
    the sentence alignment (models.train_continuous._stats_pass) of each
    rank's block of utterances, the (L, S) / (L, S, D) / (L, S, S)
    statistics summed over the ranks (counts and transitions as integers).
    Returns (counts, sums, trans, paths (B, T)), all replicated."""
    from ..models.train_continuous import _stats_pass

    dev = mesh_device(mesh)
    batch = torch.as_tensor(batch, dtype=torch.float32, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    counts, sums, trans, paths = _stats_pass(
        means_sent, covs_sent, log_a_sent, lab_of_state, loc_of_state, pos_of_state,
        shard_rows(batch, mesh), shard_rows(lengths, mesh), num_labels, s_max)
    as_int = lambda x: mesh_sum(x.to(torch.int64), mesh).to(torch.float32)  # noqa: E731
    return as_int(counts), mesh_sum(sums, mesh), as_int(trans), gather_rows(paths, mesh)


def dp_composite_decode(
    means, covs, log_a, lower_of_state, is_entry, is_exit, penalty,
    batch, lengths, mesh,
):
    """Sharded continuous decoding: each rank decodes its block of the batch
    (whitening emissions, then the dense composite decode: K4 + K2-bt on a
    card, their plain versions on the CPU) and the scores (B,) and paths
    (B, T) are gathered; no sum is needed. B must divide over the ranks
    (ValueError), as shard_map requires."""
    dev = mesh_device(mesh)
    batch = torch.as_tensor(batch, dtype=torch.float32, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    params = make_gaussian_params(means, covs, device=dev)
    log_b = gaussian_log_pdf(params, shard_rows(batch, mesh))
    scores, paths = viterbi_composite_batch_pallas(
        log_b, log_a, lower_of_state, is_entry, is_exit, penalty, shard_rows(lengths, mesh))
    return gather_rows(scores, mesh), gather_rows(paths, mesh)
