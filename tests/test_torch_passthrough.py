"""K4's passthrough kernel (`csrc/stft_variants.cu` `passthrough_kernel`)
modelled in numpy, tile by tile, since no CPU test can run it.

The model follows the kernel: a block per (tile of `TILE_ROWS` output
rows, batch row); its staged span of (rows + ratio - 1) * hop samples,
16-byte loads where the span's first sample is 16-byte aligned and 4-byte
loads otherwise, zeros past T; the planes summed in order; float4 stores
where lanes % 4 == 0 and scalar stores otherwise. At every geometry that
`chip_smoke.py` phase 4d holds the kernel to on the card, the model must
equal `passthrough_plain` bit for bit and write every output exactly
once. Tolerance: none (bit-equal), as the kernel's gate on the card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from spectrogram_cube_clustering_tpu_torch.ops import cuda_stft_variants as stv


def kernel_model(x: np.ndarray, hop: int, ratio: int, rows: int, lanes: int):
    """(out, how many times each output was written, tiles staged with
    16-byte loads, tiles staged with 4-byte loads, output rows stored as
    float4, output rows stored as scalars) of the kernel on (B, T) x."""
    b_rows, t = x.shape
    out = np.full((b_rows, rows, lanes), np.nan, np.float32)
    written = np.zeros((b_rows, rows, lanes), np.int64)
    n_vec_loads = n_scalar_loads = n_vec_rows = n_scalar_rows = 0
    vec4 = lanes % 4 == 0  # torch.empty's storage is 256-byte aligned
    tile = stv.TILE_ROWS
    for bx in range(-(-rows // tile)):
        f0 = bx * tile
        nr = min(tile, rows - f0)
        span = (nr + ratio - 1) * hop
        s0 = f0 * hop
        for b in range(b_rows):
            n_in = max(0, min(span, t - s0))
            if (b * t + s0) % 4 == 0:  # x's storage is 256-byte aligned
                n_vec_loads += 1
            else:
                n_scalar_loads += 1
            stage = np.zeros(span, np.float32)
            stage[:n_in] = x[b, s0:s0 + n_in]
            planes = stage.reshape(nr + ratio - 1, hop)
            acc = planes[:nr].copy()
            for j in range(1, ratio):
                acc = acc + planes[j:j + nr]  # float32, round to nearest
            tile_out = np.zeros((nr, lanes), np.float32)
            tile_out[:, :hop] = acc
            out[b, f0:f0 + nr] = tile_out
            written[b, f0:f0 + nr] += 1
            if vec4:
                n_vec_rows += nr
            else:
                n_scalar_rows += nr
    return out, written, n_vec_loads, n_scalar_loads, n_vec_rows, \
        n_scalar_rows


@pytest.mark.parametrize("geometry", chip_smoke.PASSTHROUGH_GEOMETRIES,
                         ids=lambda g: "x".join(map(str, g)))
def test_tiling_model_equals_plain_and_covers_every_output_once(geometry):
    b, t, hop, ratio, lanes, rows = geometry
    x = np.random.default_rng(t).normal(size=(b, t)).astype(np.float32)
    out, written, vl, sl, vr, sr = kernel_model(x, hop, ratio, rows, lanes)
    want = stv.passthrough_plain(torch.from_numpy(x), hop, ratio, rows, lanes)
    assert np.array_equal(out, want.numpy())  # bit-equal, NaN-free
    assert (written == 1).all()
    n_tiles = -(-rows // stv.TILE_ROWS) * b
    assert vl + sl == n_tiles and vr + sr == b * rows
    if t % 4 and b > 1:  # later batch rows start unaligned
        assert sl > 0
    if b == 1 and t % 4 == 0 and hop % 4 == 0:
        assert sl == 0
    assert (sr > 0) == (lanes % 4 != 0)


def test_geometries_cover_the_kernels_cases():
    """The 4d list reaches every branch of the kernel: ragged T, unaligned
    rows, ratio 1 and 3, lanes == hop and 128, scalar stores, rows not a
    multiple of the tile."""
    g = chip_smoke.PASSTHROUGH_GEOMETRIES
    assert any(t % 4 and b > 1 for b, t, *_ in g)
    assert {1, 2, 3} <= {ratio for _, _, _, ratio, _, _ in g}
    assert any(lanes == hop for _, _, hop, _, lanes, _ in g)
    assert any(lanes == 128 for *_, lanes, _ in g)
    assert any(lanes % 4 for *_, lanes, _ in g)
    assert any(rows % stv.TILE_ROWS for *_, rows in g)
    assert any((rows + ratio - 1) * hop > t for _, t, hop, ratio, _, rows in g)


@pytest.mark.parametrize("kw", [
    dict(b=1, t=2**31, rows=10, lanes=128, hop=100, ratio=2),
    dict(b=1, t=1000, rows=2**24, lanes=128, hop=100, ratio=2),
    dict(b=1, t=1000, rows=2**25, lanes=100, hop=100, ratio=2),
    dict(b=2**31, t=1000, rows=10, lanes=128, hop=100, ratio=2),
    dict(b=1, t=1000, rows=10, lanes=1024, hop=1000, ratio=2),
])
def test_geometry_past_32_bits_is_refused(kw):
    """A batch row whose samples, outputs or staged span need more than 32
    bits, or a tile whose staged span exceeds a block's shared memory,
    raises ValueError before any launch."""
    with pytest.raises(ValueError, match="32-bit|shared memory"):
        stv.check_passthrough_range(**kw)
    small = dict(kw, b=1, t=1000, rows=10, lanes=128, hop=100)
    stv.check_passthrough_range(**small)  # in range: no error


def test_no_samples_stage_zeros():
    """T = 0 is refused before any launch (ValueError, as every refused
    geometry), so no tile ever stages an empty row; one sample is in
    range, and its tiles stage that sample and zeros past it."""
    with pytest.raises(ValueError, match="empty"):
        stv.check_passthrough_range(2, 0, 3, 128, 100, 2)
    stv.check_passthrough_range(2, 1, 3, 128, 100, 2)
    x = np.ones((2, 1), np.float32)
    out, written, *_ = kernel_model(x, 100, 2, 3, 128)
    want = stv.passthrough_plain(torch.from_numpy(x), 100, 2, 3, 128)
    assert np.array_equal(out, want.numpy()) and out.sum() == 2
    assert (written == 1).all()
