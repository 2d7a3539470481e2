"""Classification metrics from confusion matrices (``fedtpu.ops.metrics``).

Accuracy and weighted precision / recall / F1 with ``zero_division=0``
(sklearn's ``average='weighted'``), derived from a ``(K, K)`` confusion
matrix (rows = true class, cols = predicted). Summing per-client confusion
matrices is concatenating their predictions, so pooled metrics are exact.
"""

from __future__ import annotations

import torch

METRIC_NAMES = ("accuracy", "precision", "recall", "f1")
NEAR_TIE_REL = 1e-5


def one_hot(v: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot of integer ``v``; values outside [0, K) give an
    all-zero row, as ``jax.nn.one_hot``. A comparison, so unlike
    ``F.one_hot`` it never reads its input back to the host."""
    classes = torch.arange(num_classes, device=v.device)
    return (v.unsqueeze(-1) == classes).to(torch.float32)


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor,
                     mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``(..., K, K)`` masked confusion counts from ``(..., N)`` labels,
    predictions and mask: ``(onehot(labels) * mask)^T @ onehot(preds)`` in
    float32, exact while counts stay below 2^24."""
    lab = one_hot(labels, num_classes) * mask.to(torch.float32).unsqueeze(-1)
    return torch.matmul(lab.transpose(-1, -2), one_hot(preds, num_classes))


def metrics_from_confusion(conf: torch.Tensor) -> dict:
    """accuracy + weighted precision/recall/f1 of ``(..., K, K)`` counts."""
    conf = conf.to(torch.float32)
    total = conf.sum(dim=(-2, -1)).clamp_min(1.0)
    support = conf.sum(dim=-1)           # per true class
    predicted = conf.sum(dim=-2)         # per predicted class
    tp = torch.diagonal(conf, dim1=-2, dim2=-1)

    def safe_div(num, den):
        pos = den > 0
        return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)

    prec_c = safe_div(tp, predicted)
    rec_c = safe_div(tp, support)
    f1_c = safe_div(2.0 * prec_c * rec_c, prec_c + rec_c)

    wsum = support.sum(dim=-1).clamp_min(1.0)
    return {
        "accuracy": tp.sum(dim=-1) / total,
        "precision": (support * prec_c).sum(dim=-1) / wsum,
        "recall": (support * rec_c).sum(dim=-1) / wsum,
        "f1": (support * f1_c).sum(dim=-1) / wsum,
    }


def near_tie_rows(logits: torch.Tensor) -> torch.Tensor:
    """Rows whose top-two logit gap is below ``NEAR_TIE_REL * max|logit|``:
    an fp32 sum taken in another order may flip their argmax, so two
    implementations may count them in different cells."""
    top2 = torch.topk(logits, 2, dim=-1).values
    scale = logits.abs().amax(dim=-1).clamp_min(1e-30)
    return (top2[..., 0] - top2[..., 1]) < NEAR_TIE_REL * scale
