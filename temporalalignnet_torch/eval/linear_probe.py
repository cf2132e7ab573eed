"""Linear-probe action recognition, the end-to-end path's evaluation
(counterpart of temporalalignnet_tpu/eval/linear_probe.py; the reference
reports its S3D fine-tune by linear probes on UCF101 / HMDB51 / K400,
end2end/readme.md:11-13, and ships no probe code).

A full-batch multinomial logistic regression on the device: features
standardised by the training set's mean and standard deviation (ddof 0, as
``jnp.std``; at least 1e-6), ``w`` ~ N(0, 0.01²), ``b`` = 0, Adam (lr 1e-2)
for ``steps`` full-batch steps on mean cross-entropy + ``l2``·‖w‖² (L2 on
``w`` only); top-1 and top-5 by a stable sort of the test logits.  JAX's
``PRNGKey`` draw of ``w`` cannot be reproduced in torch, so ``linear_probe``
draws it from ``torch.Generator(seed)`` and the fit itself is ``_fit``, which
the tests hand JAX's initial ``w``.

    encode = make_s3d_encoder("params_latest.pth")   # tools/extract_features.py
    train_f = np.concatenate([encode(b) for b in train_clips])
    metrics = linear_probe(train_f, train_y, test_f, test_y, num_classes=101)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def linear_probe(train_features: np.ndarray, train_labels: np.ndarray,
                 test_features: np.ndarray, test_labels: np.ndarray, num_classes: int,
                 l2: float = 1e-4, lr: float = 1e-2, steps: int = 500, normalize: bool = True,
                 seed: int = 0, device: str = "cuda") -> Dict[str, float]:
    """{'top1', 'top5', 'final_train_loss'} of the probe; ``device`` the card
    unless the caller asks for the CPU."""
    gen = torch.Generator().manual_seed(seed)
    w0 = torch.randn(train_features.shape[1], num_classes, generator=gen) * 0.01
    return _fit(w0, train_features, train_labels, test_features, test_labels, num_classes,
                l2=l2, lr=lr, steps=steps, normalize=normalize, device=device)


def _fit(w0, train_features, train_labels, test_features, test_labels, num_classes: int,
         l2: float, lr: float, steps: int, normalize: bool, device: str) -> Dict[str, float]:
    """The probe from the initial ``w0`` [D, num_classes]; ``final_train_loss``
    is the loss of the last step (before its update), as JAX's scan keeps it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("linear_probe: no CUDA device (pass device='cpu' for the CPU)")
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    Xtr, Xte = f32(train_features), f32(test_features)
    ytr = torch.as_tensor(np.asarray(train_labels), device=dev).long()
    yte = torch.as_tensor(np.asarray(test_labels), device=dev).long()
    if normalize:
        mu = Xtr.mean(0, keepdim=True)
        sd = Xtr.std(0, keepdim=True, correction=0).clamp_min(1e-6)
        Xtr, Xte = (Xtr - mu) / sd, (Xte - mu) / sd
    w = f32(np.asarray(w0)).requires_grad_()
    b = torch.zeros(num_classes, device=dev, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss = torch.zeros((), device=dev)
    for _ in range(steps):
        step_loss = F.cross_entropy(Xtr @ w + b, ytr) + l2 * (w * w).sum()
        opt.zero_grad()
        step_loss.backward()
        opt.step()
        loss = step_loss.detach()
    with torch.no_grad():
        order = torch.argsort(-(Xte @ w + b), dim=1, stable=True)
        top1 = (order[:, 0] == yte).float().mean()
        top5 = (order[:, :min(5, num_classes)] == yte[:, None]).any(1).float().mean()
    return {"top1": float(top1), "top5": float(top5), "final_train_loss": float(loss)}
