"""One CLU-VE task through the reference: personalise on the real context
frames, then the logits of every query frame."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from port_bench.reference.heads import HEADS, masked_logits


@torch.no_grad()
def personalise(model, context: torch.Tensor, labels: torch.Tensor, num_classes: int) -> dict:
    """uint8 (N, H, W, 3) real context frames and their labels -> the task
    state: the FiLM values (with FiLM), and the head."""
    film = model.film(context)[0] if model.adapt else None
    configure, _ = HEADS[model.a["classifier"]]
    return {"film": film, "head": configure(model.embed(context, film), labels, num_classes)}


@torch.no_grad()
def predict(model, state: dict, query: np.ndarray, way: int, device,
            block: int = 2048, rows: Optional[np.ndarray] = None) -> np.ndarray:
    """(M, H, W, 3) uint8 query frames on the host -> (M, C) float32 logits
    on the host, padded classes at -1e30; ``rows`` selects frames."""
    _, logits_fn = HEADS[model.a["classifier"]]
    idx = np.arange(len(query)) if rows is None else rows
    out = []
    for i in range(0, len(idx), block):
        frames = torch.from_numpy(np.ascontiguousarray(query[idx[i:i + block]])).to(device)
        out.append(masked_logits(logits_fn(state["head"], model.embed(frames, state["film"])),
                                 way).cpu())
    return torch.cat(out).numpy()
