"""Set-up and checks shared by the BCNN traffic kinds: weights and images
from the seed, the program's engine, and the plain reference's logits of
every image the cell sends."""
from __future__ import annotations

import numpy as np
import torch

from h100bench import programs, weights
from h100bench.reference import bcnn_plain


def inputs(run):
    """(latent weights, (N, 32, 32, 3) images on the device, the same as a
    host float32 array) of the seed."""
    programs.bcnn_check_config(run.config)
    latent = weights.bcnn_params(run.seed, run.device)
    imgs = weights.images(run.seed, run.params["images"], run.device)
    return latent, imgs, imgs.cpu().numpy()


def reference_logits(latent: dict, imgs: torch.Tensor,
                     control: bool = False) -> np.ndarray:
    """The plain reference's logits of ``imgs`` (the control: computed in
    bfloat16, the precision below the configuration's float32)."""
    dt = torch.bfloat16 if control else torch.float32
    return bcnn_plain.logits(latent, imgs, dtype=dt).cpu().numpy()


def wrong_rows(got: np.ndarray, want: np.ndarray) -> int:
    """Rows of ``got`` that are not bit for bit ``want``'s."""
    return int(np.sum(np.any(got != want, axis=-1)))


def explain(latent: dict, imgs: torch.Tensor, got: np.ndarray,
            want: np.ndarray, image_of: np.ndarray) -> str:
    """Where answers differ from the reference: how many distinct images,
    the largest gap, and a second witness, the reference on the CPU in
    float64 for up to 8 of those images (does it side with the program or
    with the reference?)."""
    bad = np.flatnonzero(np.any(got != want, axis=-1))
    if len(bad) == 0:
        return "no answer differs"
    imgs_bad = np.unique(image_of[bad])
    first = {}
    for i in bad:
        first.setdefault(int(image_of[i]), int(i))
    pick = imgs_bad[:8]
    cpu = {k: v.cpu() for k, v in latent["conv1"].items()}
    lat = {"conv1": cpu,
           "convs": [{k: v.cpu() for k, v in p.items()}
                     for p in latent["convs"]],
           "fcs": [{k: v.cpu() for k, v in p.items()} for p in latent["fcs"]]}
    wit = bcnn_plain.logits(lat, imgs[torch.as_tensor(pick)].cpu())
    wit = wit.numpy()
    prog = np.stack([got[first[int(m)]] for m in pick])
    ref = np.stack([want[first[int(m)]] for m in pick])
    return (f"{len(bad)} answers of {len(imgs_bad)} distinct images differ; "
            f"largest gap {float(np.abs(got[bad] - want[bad]).max())!r}; "
            f"the CPU witness equals the program on "
            f"{int(np.all(wit == prog, axis=-1).sum())} and the reference on "
            f"{int(np.all(wit == ref, axis=-1).sum())} of {len(pick)}")
