"""The copied generators against `chip_smoke.py`'s originals."""

import collections
import itertools

import numpy as np
import torch

import chip_smoke
from portbench.traffic import events, requests, waveform


def test_synthetic_waveform_bit_equal():
    for kinds, amp in ((None, None), (None, 10.0)):
        a = chip_smoke.synthetic_waveform(
            (2, 4321), torch.Generator().manual_seed(7), "cpu", kinds, amp)
        b = waveform.synthetic_waveform(
            (2, 4321), torch.Generator().manual_seed(7), "cpu", kinds, amp)
        assert torch.equal(a, b)


def test_training_waveform_draws_as_phase_4b():
    gen = torch.Generator().manual_seed(11)
    kinds = torch.randint(0, 5, (2, -(-4000 // 400)), generator=gen)
    want = chip_smoke.synthetic_waveform((2, 4000), gen, "cpu", kinds, 10.0)
    got = waveform.training_waveform((2, 4000),
                                     torch.Generator().manual_seed(11), "cpu")
    assert torch.equal(got, want)


def test_planted_events_bit_equal_given_the_draws():
    """`build_h5_catalog`'s rows from numpy's draws, built by the copy;
    the conversion (crop, vec_norm) equal to float32 rounding."""
    from spectrogram_cube_clustering_tpu_torch.data.h5 import (
        crop_specgram,
        normalize_specgram,
    )

    m, seed = 40, 3
    rng = np.random.default_rng(seed + 11)
    truth = np.arange(m) % chip_smoke.H5_CLASSES
    bands = np.zeros((chip_smoke.H5_CLASSES, chip_smoke.H5_RAW[0], 1))
    for k in range(chip_smoke.H5_CLASSES):
        bands[k, 4 + 16 * k:18 + 16 * k] = 1.0
    noise = rng.normal(scale=0.1, size=(m, *chip_smoke.H5_RAW))
    amp = 3.0 + rng.normal(scale=0.2, size=(m, 1, 1))
    raw = noise.copy()  # the lines of build_h5_catalog's loop
    raw[:, :, 1:] += bands[truth] * amp
    raw[:, 87, 1:] = np.arange(100)
    raw[:, 0:87, 0] = np.linspace(0, 10, 87)
    got = events.planted_events(torch.from_numpy(noise),
                                torch.from_numpy(amp),
                                torch.from_numpy(truth))
    assert np.array_equal(got.numpy(), raw)
    dump = normalize_specgram(crop_specgram(raw.astype(np.float32)),
                              "vec_norm")
    np.testing.assert_allclose(events.crop_vec_norm(got).numpy(), dump,
                               rtol=2e-6, atol=1e-8)


def test_catalog_dump_shape_and_classes():
    x, truth = events.catalog_dump(70, torch.Generator().manual_seed(1),
                                   "cpu")
    assert x.shape == (70, 87, 100, 1) and x.dtype == torch.float32
    assert torch.equal(truth, torch.arange(70) % 5)
    norms = x.double().square().sum(dim=(1, 2, 3)).sqrt()
    assert torch.allclose(norms, torch.ones(70, dtype=torch.float64),
                          atol=1e-6)


MIX = [{"shape": [8000], "per_cycle": 6, "pool": 16},
       {"shape": [400000], "per_cycle": 3, "pool": 8},
       {"shape": [16, 1048576], "per_cycle": 1, "pool": 4}]


def test_every_seed_offers_the_same_work_in_another_order():
    orders = []
    for seed in (1, 2**31 + 5):
        first = list(itertools.islice(requests.schedule(seed, 0, MIX), 50))
        for cycle in range(5):
            counts = collections.Counter(
                c for c, _ in first[10 * cycle:10 * cycle + 10])
            assert counts == {0: 6, 1: 3, 2: 1}
        orders.append(first)
    assert orders[0] != orders[1]
    assert all(j < MIX[c]["pool"] for c, j in orders[0])


def test_payloads_repeat_from_their_numbers():
    small = [{"shape": [8000], "per_cycle": 1, "pool": 2},
             {"shape": [2, 3000], "per_cycle": 1, "pool": 1}]
    a = requests.payload(2**33 + 1, 0, 1, small)
    assert np.array_equal(a, requests.payload(2**33 + 1, 0, 1, small))
    assert not np.array_equal(a, requests.payload(2**33 + 1, 0, 0, small))
    assert requests.payload(5, 1, 0, small).shape == (2, 3000)
