"""The reference network's equations in plain functional PyTorch.

A frozen copy of the AEC and DEC of `Cluster/networks.py:172-323` (the
autoencoder, its SpatialAttention and the clustering layer), the Student-t
soft assignment (`networks.py:279-288`) and the DEC target distribution
(`models.py:1302-1322`), over a flat dict of parameters keyed as the
reference's state_dict (`encoder.encoder.<i>`, `decoder.decoder.<i>`,
`clustering.weights`). Any dtype; the benchmark runs it in float64.

Departures from `networks.py`, each deliberate:

- windows of any `input_hw`, not only (4, 101): the decoder's output
  paddings are solved from the encoder's shapes, so (87, 100) runs too;
- inputs and reconstructions are NHWC (B, H, W, 1), as the benchmark's
  windows are; with one channel this is a view of the reference's NCHW;
- SpatialAttention is the reference's own ("faithful") form: it returns
  a * sigmoid(a) of the attention map and drops the feature map;
- the target distribution is rounded to 5 decimals, as `models.py` rounds
  q and p before they are used (`round_decimals=None` leaves it).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

KERNEL = (2, 4)
STRIDE = (1, 2)
CHANNELS = 8
LATENT = 9


def conv_shapes(input_hw: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Spatial shapes through the encoder's three convolutions (kernel
    (2, 4), stride (1, 2), padding 1): [(h0, w0), ..., (h3, w3)]."""
    h, w = int(input_hw[0]), int(input_hw[1])
    out = [(h, w)]
    for _ in range(3):
        h = (h + 2 - KERNEL[0]) // STRIDE[0] + 1
        w = (w + 2 - KERNEL[1]) // STRIDE[1] + 1
        out.append((h, w))
    return out


def param_shapes(input_hw: Tuple[int, int],
                 n_clusters: int = 0) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape, in the reference state_dict's order; the
    clustering layer's only when `n_clusters` > 0."""
    h3, w3 = conv_shapes(input_hw)[3]
    c, (kh, kw) = CHANNELS, KERNEL
    shapes = {
        "encoder.encoder.0.weight": (c, 1, kh, kw),
        "encoder.encoder.0.bias": (c,),
        "encoder.encoder.2.weight": (c, c, kh, kw),
        "encoder.encoder.2.bias": (c,),
        "encoder.encoder.4.weight": (c, c, kh, kw),
        "encoder.encoder.4.bias": (c,),
        "encoder.encoder.6.conv.weight": (1, 2, 3, 3),
        "encoder.encoder.8.weight": (LATENT, h3 * w3),
        "encoder.encoder.8.bias": (LATENT,),
        "decoder.decoder.0.weight": (h3 * w3, LATENT),
        "decoder.decoder.0.bias": (h3 * w3,),
        "decoder.decoder.3.weight": (1, c, 3, 3),
        "decoder.decoder.5.weight": (c, c, kh, kw),
        "decoder.decoder.5.bias": (c,),
        "decoder.decoder.7.weight": (c, c, kh, kw),
        "decoder.decoder.7.bias": (c,),
        "decoder.decoder.9.weight": (c, 1, kh, kw),
        "decoder.decoder.9.bias": (1,),
    }
    if n_clusters:
        shapes["clustering.weights"] = (int(n_clusters), LATENT)
    return shapes


def xavier_bound(shape: Tuple[int, ...]) -> float:
    """The Xavier-uniform bound sqrt(6 / (fan_in + fan_out)) of a weight
    (`networks.py:157-168`; fans counted over dims 0 and 1 and the
    receptive field, as for a transposed convolution's weight too)."""
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return (6.0 / ((shape[0] + shape[1]) * receptive)) ** 0.5


def encode(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """NHWC windows (B, H, W, 1) -> latents (B, 9)."""
    p = params
    h = x.permute(0, 3, 1, 2)
    for i in (0, 2, 4):
        h = F.relu(F.conv2d(h, p[f"encoder.encoder.{i}.weight"],
                            p[f"encoder.encoder.{i}.bias"], STRIDE, 1))
    stats = torch.cat([h.mean(dim=1, keepdim=True),
                       h.amax(dim=1, keepdim=True)], dim=1)
    a = F.conv2d(stats, p["encoder.encoder.6.conv.weight"], None, 1, 1)
    h = (a * torch.sigmoid(a)).flatten(1)
    return F.relu(F.linear(h, p["encoder.encoder.8.weight"],
                           p["encoder.encoder.8.bias"]))


def decode(params: Dict[str, torch.Tensor], z: torch.Tensor,
           input_hw: Tuple[int, int]) -> torch.Tensor:
    """Latents (B, 9) -> NHWC reconstructions (B, H, W, 1)."""
    p = params
    shapes = conv_shapes(input_hw)
    h, w = shapes[3]
    y = F.relu(F.linear(z, p["decoder.decoder.0.weight"],
                        p["decoder.decoder.0.bias"]))
    y = y.reshape(-1, 1, h, w)
    y = F.relu(F.conv_transpose2d(y, p["decoder.decoder.3.weight"], None,
                                  1, 1))
    for i, (ht, wt) in zip((5, 7, 9), (shapes[2], shapes[1], shapes[0])):
        # out = (in - 1) * stride - 2 * padding + kernel + output_padding
        op = (ht - ((h - 1) * STRIDE[0] - 2 + KERNEL[0]),
              wt - ((w - 1) * STRIDE[1] - 2 + KERNEL[1]))
        y = F.relu(F.conv_transpose2d(
            y, p[f"decoder.decoder.{i}.weight"],
            p[f"decoder.decoder.{i}.bias"], STRIDE, 1, output_padding=op))
        h, w = ht, wt
    return y.permute(0, 2, 3, 1)


def soft_assign(z: torch.Tensor, mu: torch.Tensor,
                alpha: float = 1.0) -> torch.Tensor:
    """Student-t soft assignment q (B, K), rows summing to one."""
    d2 = ((z[:, None, :] - mu[None, :, :]) ** 2).sum(dim=-1)
    w = (1.0 + d2 / alpha) ** (-(alpha + 1.0) / 2.0)
    return w / w.sum(dim=-1, keepdim=True)


def target(q: torch.Tensor, round_decimals=5) -> torch.Tensor:
    """DEC target p_ij = q_ij^2 / sum_i q_ij, rows renormalised."""
    w = q * q / q.sum(dim=0, keepdim=True)
    p = w / w.sum(dim=-1, keepdim=True)
    return p if round_decimals is None else torch.round(p, decimals=round_decimals)


def aec_loss(params, x: torch.Tensor, mask: torch.Tensor, input_hw,
             with_output: bool = False):
    """Mean squared error of each real row (mask 1.0), averaged over the
    real rows; with `with_output`, (that loss, the reconstructions)."""
    xr = decode(params, encode(params, x), input_hw)
    per = ((xr - x) ** 2).mean(dim=(1, 2, 3))
    loss = (per * mask).sum() / mask.sum().clamp(min=1.0)
    return (loss, xr) if with_output else loss


def dec_loss(params, x: torch.Tensor, mask: torch.Tensor, p: torch.Tensor,
             gamma: float, input_hw, alpha: float = 1.0):
    """DEC loss over the real rows: MSE + gamma * KL(p || q), each a mean
    over the real rows; returns (total, reconstruction, clustering)."""
    z = encode(params, x)
    q = soft_assign(z, params["clustering.weights"], alpha)
    xr = decode(params, z, input_hw)
    n = mask.sum().clamp(min=1.0)
    rec = (((xr - x) ** 2).mean(dim=(1, 2, 3)) * mask).sum() / n
    logq = torch.log(q.clamp(min=torch.finfo(q.dtype).tiny))
    kl = (torch.special.xlogy(p, p) - p * logq).sum(dim=-1)
    clust = gamma * (kl * mask).sum() / n
    return rec + clust, rec, clust


def dec_outputs(params, x: torch.Tensor, alpha: float = 1.0, rows=4096):
    """(q, z) of every window, `rows` at a time."""
    qs, zs = [], []
    for lo in range(0, len(x), rows):
        z = encode(params, x[lo:lo + rows])
        zs.append(z)
        qs.append(soft_assign(z, params["clustering.weights"], alpha))
    return torch.cat(qs), torch.cat(zs)
