"""t-SNE on the host through scikit-learn: a copy (ROADMAP Queue 1 item 0)
of the JAX package's `cluster/tsne.py` (reference Cluster/models.py:
1325-1350: perplexity M/100, learning rate M/12, early exaggeration 20,
2000 iterations, seed 2009), pinned to it bit for bit by
`tests/test_torch_tsne.py`.

scikit-learn is imported when the function runs; where it is missing the
call raises ImportError naming it. The card's machine has no
scikit-learn: there the on-device t-SNE (`cluster.tsne_torch`,
`tsne_backend = jax`) is the one that runs.
"""

from __future__ import annotations

import numpy as np


def _sklearn_tsne():
    """sklearn.manifold.TSNE; ImportError naming scikit-learn where it is
    missing."""
    try:
        from sklearn.manifold import TSNE
    except ImportError as exc:
        raise ImportError(
            "the sklearn t-SNE backend needs scikit-learn, which is not "
            "installed; install it or set tsne_backend = jax") from exc
    return TSNE


def tsne(data, *, seed: int = 2009, n_iter: int = 2000) -> np.ndarray:
    """2-D t-SNE of data (M, D) with the reference's hyperparameters."""
    TSNE = _sklearn_tsne()
    data = np.asarray(data, dtype=np.float32)
    m = len(data)
    perplexity = max(min(int(m / 100), m - 1), 1)
    kwargs = dict(
        n_components=2,
        perplexity=perplexity,
        early_exaggeration=20,
        learning_rate=max(int(m / 12), 1),
        verbose=0,
        random_state=seed,
    )
    try:
        model = TSNE(max_iter=n_iter, **kwargs)
    except TypeError:  # sklearn < 1.5
        model = TSNE(n_iter=n_iter, **kwargs)
    return model.fit_transform(data)
