"""The port's fused decode (ops/cuda/emission.decode_batch_fused: quad-form
emissions -> scan-free trellis pair, here through their plain versions on CPU
tensors) against the JAX package's decode_batch_fused with its Pallas kernels
in interpret mode, on the 58-state flagship and bench.py-style audio.

Emissions differ from JAX only in float32 summation order, so transcripts
must be identical and scores agree to rtol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import torch

from cs304_tpu.ops.mfcc import mfcc_features_batch as j_mfcc
from cs304_tpu.ops.pallas.emission import decode_batch_fused as j_fused
from cs304_tpu_torch.data.batching import make_signals
from cs304_tpu_torch.models.hmm import flagship_composite
from cs304_tpu_torch.ops.cuda.emission import decode_batch_fused


def test_decode_batch_fused_matches_pallas_interpret():
    comp = flagship_composite()
    sig = make_signals(8, 1.5)
    n_samples = np.full(8, sig.shape[1], np.int32)
    n_samples[3] = 17000  # one ragged clip
    feats, n_frames = j_mfcc(sig, n_samples)
    feats, n_frames = np.array(feats), np.array(n_frames)
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    j_s, j_p = j_fused(jnp.asarray(comp.means), jnp.asarray(comp.covariances),
                       *(jnp.asarray(a) for a in topo), jnp.float32(comp.penalty),
                       jnp.asarray(feats), jnp.asarray(n_frames), interpret=True)
    t_s, t_p = decode_batch_fused(
        torch.as_tensor(comp.means), torch.as_tensor(comp.covariances), *topo,
        comp.penalty, torch.as_tensor(feats), torch.as_tensor(n_frames),
    )
    assert t_p.shape == (8, 151) and t_p.dtype == torch.int32
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=1e-4)
    j_p, t_p = np.asarray(j_p), t_p.numpy()
    for i, n in enumerate(n_frames):
        assert comp.path_to_labels(t_p[i, :n]) == comp.path_to_labels(j_p[i, :n])
