"""Built-in datasets with the Keras loader API, the PyTorch counterpart of
``flexflow_tpu/keras/datasets.py``.

reference: python/flexflow/keras/datasets/{mnist,cifar,cifar10,reuters}.py
— thin loaders that download archives and return ((x_train, y_train),
(x_test, y_test)). Nothing is downloaded: the loaders here read a local
cache (``FLEXFLOW_DATASETS_DIR`` or ~/.keras/datasets,
the same path Keras populates) and otherwise fall back to a DETERMINISTIC
synthetic sample with the real shapes/dtypes/label ranges — enough for the
convergence-gate tests and examples to run hermetically. The return
contract matches Keras exactly.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


def _cache_dir() -> str:
    return os.environ.get(
        "FLEXFLOW_DATASETS_DIR",
        os.path.join(os.path.expanduser("~"), ".keras", "datasets"))


def _try_npz(fname: str, keys=("x_train", "y_train", "x_test", "y_test")
             ) -> Optional[Arrays]:
    path = os.path.join(_cache_dir(), fname)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=True) as f:
        xt, yt, xe, ye = (f[k] for k in keys)
        return (xt, yt), (xe, ye)


def _synth_images(shape, classes, n_train, n_test, seed) -> Arrays:
    """Separable synthetic image classes: each class is a fixed random
    template plus pixel noise — a rich, well-conditioned signal so small
    models converge on it quickly (the accuracy-gate tests need a
    learnable signal, not noise)."""
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0, 255, (classes,) + shape).astype(np.float32)

    def make(n):
        y = rng.integers(0, classes, n).astype(np.int64)
        noise = rng.normal(0, 64, (n,) + shape).astype(np.float32)
        x = np.clip(templates[y] + noise, 0, 255)
        return x.astype(np.uint8), y
    xt, yt = make(n_train)
    xe, ye = make(n_test)
    return (xt, yt), (xe, ye)


class mnist:
    """reference: keras/datasets/mnist.py load_data."""

    @staticmethod
    def load_data(path: str = "mnist.npz") -> Arrays:
        cached = _try_npz(path)  # Keras' own mnist.npz layout
        if cached is not None:
            return cached
        return _synth_images((28, 28), 10, 6000, 1000, seed=0)


class cifar10:
    """reference: keras/datasets/cifar10.py load_data (NCHW uint8)."""

    @staticmethod
    def load_data() -> Arrays:
        cached = _try_npz("cifar10.npz")
        if cached is not None:
            return cached
        (xt, yt), (xe, ye) = _synth_images((3, 32, 32), 10, 5000, 1000, seed=1)
        return (xt, yt.reshape(-1, 1)), (xe, ye.reshape(-1, 1))


class reuters:
    """reference: keras/datasets/reuters.py load_data (token-id sequences)."""

    @staticmethod
    def load_data(num_words: int = 10000, maxlen: int = 80,
                  test_split: float = 0.2, seed: int = 113) -> Arrays:
        cached = _try_npz("reuters_ff.npz")
        if cached is not None:
            return cached
        rng = np.random.default_rng(seed)
        n = 2000
        classes = 46
        y = rng.integers(0, classes, n).astype(np.int64)
        # class-dependent token distribution for learnability
        base = (y[:, None] * 97) % num_words
        x = (base + rng.integers(0, 50, (n, maxlen))) % num_words
        x = x.astype(np.int64)
        split = int(n * (1.0 - test_split))
        return (x[:split], y[:split]), (x[split:], y[split:])
