"""Evaluation metrics: PSNR, SSIM, FID and KID from features (a copy of
`mvedit_tpu/utils/evaluation.py`'s host numpy; the reference's
`lib/core/evaluation/metrics.py:52-215`):
- `eval_psnr`, `eval_ssim` (an 11 x 11 gaussian window, the reference's
  skimage-compatible constants);
- `fid_from_feats` (Frechet distance) and `kid_from_feats` (polynomial
  kernel MMD over subsets) on (N, D) feature arrays, such as the
  InceptionV3 pool3 features of `models/inception.py` (`tools.
  inception_stat` writes a dataset's)."""
import math

import numpy as np

__all__ = ["eval_psnr", "eval_ssim", "fid_from_feats", "kid_from_feats"]


def eval_psnr(img1, img2, max_val=1.0):
    """(..., H, W, C) -> (...,) PSNR per image."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    mse = ((img1 - img2) ** 2).mean(axis=(-3, -2, -1))
    return 10.0 * np.log10(max_val ** 2 / np.clip(mse, 1e-12, None))


def _gaussian_window(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def eval_ssim(img1, img2, max_val=1.0):
    """SSIM with 11x11 gaussian window (metrics.py:83-135 semantics).
    img: (H, W, C) or (N, H, W, C); returns scalar / (N,)."""
    from scipy.signal import convolve2d
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 4:
        return np.array([eval_ssim(a, b, max_val)
                         for a, b in zip(img1, img2)])
    win = np.outer(_gaussian_window(), _gaussian_window())
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    vals = []
    for c in range(img1.shape[-1]):
        x, y = img1[..., c], img2[..., c]
        mu_x = convolve2d(x, win, mode="valid")
        mu_y = convolve2d(y, win, mode="valid")
        xx = convolve2d(x * x, win, mode="valid") - mu_x ** 2
        yy = convolve2d(y * y, win, mode="valid") - mu_y ** 2
        xy = convolve2d(x * y, win, mode="valid") - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * xy + c2)) / (
            (mu_x ** 2 + mu_y ** 2 + c1) * (xx + yy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def fid_from_feats(feats_a, feats_b, eps=1e-6):
    """Frechet distance between feature sets (N, D)."""
    import scipy.linalg
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False)
    s2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    # sqrtm's `disp` kwarg is deprecated (removal slated for SciPy 1.18);
    # call plainly and gate the regularized retry on finiteness instead
    covmean = scipy.linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        covmean = scipy.linalg.sqrtm(
            (s1 + eps * np.eye(len(s1))) @ (s2 + eps * np.eye(len(s2))))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2 * np.trace(covmean))


def kid_from_feats(feats_a, feats_b, num_subsets=100, subset_size=1000,
                   rng=None):
    """KID: polynomial-kernel MMD^2 averaged over subsets (metrics.py KID)."""
    rng = rng or np.random.default_rng(0)
    n = feats_a.shape[1]
    m = min(subset_size, len(feats_a), len(feats_b))
    t = 0.0
    for _ in range(num_subsets):
        x = feats_a[rng.choice(len(feats_a), m, replace=False)]
        y = feats_b[rng.choice(len(feats_b), m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - 2 * b.sum() / m
    return float(t / num_subsets / m)
