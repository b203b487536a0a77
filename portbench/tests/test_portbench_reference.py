"""The plain reference against the port at small sizes on the CPU, from
the same weights and windows."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import network, split
from portbench.reference import stft as ref_stft


def _weights(hw, k, scale=1.0):
    w = harness.seeded_weights(network.param_shapes(hw, k),
                               torch.Generator().manual_seed(5), "cpu")
    harness.scale_latent_head(w, scale)
    return w


@pytest.mark.parametrize("hw", [(4, 101), (87, 100)])
def test_network_matches_the_port(hw):
    from spectrogram_cube_clustering_tpu_torch.models.build import (
        build_model,
    )

    w = _weights(hw, 5, 100.0)
    model = build_model("DEC", "AEC", hw, True, 5, device="cpu")
    model.load_state_dict(w)  # the reference's keys and shapes, strictly
    x = torch.randn(6, *hw, 1, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        q, xr, z = model(x)
    w64 = {k: v.double() for k, v in w.items()}
    z_ref = network.encode(w64, x.double())
    torch.testing.assert_close(z.double(), z_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        xr.double(), network.decode(w64, z_ref, hw), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        q.double(), network.soft_assign(z_ref, w64["clustering.weights"]),
        rtol=1e-5, atol=1e-7)


def test_target_and_losses_match_the_port():
    from spectrogram_cube_clustering_tpu_torch.ops import losses, student_t

    g = torch.Generator().manual_seed(3)
    q = torch.softmax(torch.randn(50, 5, generator=g, dtype=torch.float64),
                      dim=1)
    torch.testing.assert_close(network.target(q),
                               student_t.target_distribution(q))
    hw = (4, 101)
    w = {k: v.double() for k, v in _weights(hw, 5, 100.0).items()}
    x = torch.randn(8, *hw, 1, generator=g, dtype=torch.float64)
    mask = torch.ones(8, dtype=torch.float64)
    z = network.encode(w, x)
    qb = network.soft_assign(z, w["clustering.weights"])
    p = network.target(qb)
    total, rec, clust = network.dec_loss(w, x, mask, p, 1e-3, hw)
    want, _ = losses.dec_loss(network.decode(w, z, hw), x, qb, p, 1e-3)
    torch.testing.assert_close(total, want)
    torch.testing.assert_close(network.aec_loss(w, x, mask, hw), rec)


def test_stft_and_windows_match_the_port():
    from spectrogram_cube_clustering_tpu_torch.signal.stft import (
        spectrogram_windows,
    )

    wave = torch.randn(2, 9000, generator=torch.Generator().manual_seed(4))
    got = spectrogram_windows(wave)  # the port's plain path on the CPU
    ref = ref_stft.sample_norm_cent(
        ref_stft.windows(ref_stft.log_power(wave)))
    assert got.shape == ref.shape
    assert float((got.double() - ref).abs().max()) < 1e-6
    lo = ref_stft.log_power(wave, dtype=torch.float32)
    assert lo.dtype == torch.float32


def test_split_matches_the_port():
    from spectrogram_cube_clustering_tpu_torch.data.cube import (
        train_val_split,
    )

    for n in (10, 41_936):
        for a, b in zip(split.train_val_split(n), train_val_split(n)):
            assert np.array_equal(a, b)


def test_adam_follows_torch():
    from portbench.reference.train import follow

    hw = (4, 101)
    w = _weights(hw, 0)
    x = torch.randn(3, 16, *hw, 1, generator=torch.Generator().manual_seed(9))
    mask = torch.ones(16)
    out = follow(w, [(xb.double(), mask.double()) for xb in x],
                 lambda p, b: network.aec_loss(p, b[0], b[1], hw), 1e-3,
                 torch.float64)
    params = {k: v.double().clone().requires_grad_(True) for k, v in w.items()}
    opt = torch.optim.Adam(params.values(), lr=1e-3)
    for xb in x:
        opt.zero_grad()
        network.aec_loss(params, xb.double(), mask.double(), hw).backward()
        opt.step()
    for k in w:
        torch.testing.assert_close(out["params"][k], params[k].detach())
