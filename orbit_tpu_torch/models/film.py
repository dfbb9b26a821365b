"""FiLM adaptation of the backbone's norms (counterpart of
``orbit_tpu/models/film.py``; reference: model/feature_adapters.py:36-78,
model/film.py:38-94).

- A ``film_spec`` lists ``(param_path, size)`` for every FiLM-able norm
  ``scale``/``bias`` leaf of the extractor (the backbone factory makes it).
- :class:`FilmParameterGenerator` holds one DenseBlock(64, 64, size) and one
  regulariser ``reg ~ N(0, 0.001)`` per leaf, in sorted dotted-name order,
  and maps a 64-d task embedding to multipliers (scale leaves:
  ``g * reg + 1``) and offsets (bias leaves: ``g * reg``), plus the L2 term
  of the regularisers.
- :func:`film_values_from_initial` applies them to the leaves' *initial*
  values (the reference's quirk: it multiplies its detached initial copy,
  not the live parameter).

The result is a dict keyed by dotted names (``blocks_1_0.bn2.scale``) that
the extractor takes as per-call overrides (``extractor(x, film)``); no
parameter is ever mutated.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from orbit_tpu_torch.models.mlps import DenseBlock
from orbit_tpu_torch.models.set_encoder import SET_ENCODER_OUTPUT_SIZE

FilmSpec = Sequence[Tuple[Tuple[str, ...], int]]
FilmValues = Dict[str, torch.Tensor]


def spec_names(film_spec: FilmSpec) -> List[str]:
    """Dotted names of the spec's leaves, sorted (the reference sorts its
    film parameter names, feature_adapters.py:43-44)."""
    return sorted(".".join(path) for path, _ in film_spec)


def get_initial_film_values(extractor: nn.Module, film_spec: FilmSpec) -> FilmValues:
    """The FiLM leaves' current values, by dotted name (reference:
    film.py:81-87)."""
    params = dict(extractor.named_parameters())
    return {name: params[name] for name in spec_names(film_spec)}


def film_values_from_initial(initial: FilmValues, generated: FilmValues) -> FilmValues:
    """Scale leaves multiply, bias leaves add (reference:
    feature_adapters.py:71-75)."""
    return {name: initial[name] * g if name.endswith(".scale") else initial[name] + g
            for name, g in generated.items()}


class FilmParameterGenerator(nn.Module):
    """One DenseBlock + regulariser per FiLM leaf; parameters keep the Flax
    names ``gen__<path with _>`` and ``reg__<path with _>``."""

    def __init__(self, film_spec: FilmSpec, hidden_size: int = 64):
        super().__init__()
        sizes = {".".join(path): size for path, size in film_spec}
        self.names = spec_names(film_spec)
        for name in self.names:
            if name.rsplit(".", 1)[-1] not in ("scale", "bias"):
                raise ValueError(f"FiLM leaf must be scale/bias, got {name}")
            tag = name.replace(".", "_")
            self.add_module(f"gen__{tag}", DenseBlock(SET_ENCODER_OUTPUT_SIZE, hidden_size,
                                                      sizes[name]))
            self.register_parameter(f"reg__{tag}", nn.Parameter(torch.zeros(sizes[name])))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        for name in self.names:
            tag = name.replace(".", "_")
            gen = getattr(self, f"gen__{tag}")
            gen.fc1.reset_parameters(g)
            gen.ln.reset_parameters(g)
            gen.fc2.reset_parameters(g)
            getattr(self, f"reg__{tag}").normal_(0.0, 0.001, generator=g)

    def forward(self, task_embedding: torch.Tensor):
        """(64,) or (1, 64) f32 -> (generated values by dotted name, L2 term
        of the regularisers)."""
        e = task_embedding.float().reshape(1, -1)
        generated: FilmValues = {}
        l2 = torch.zeros((), device=e.device)
        for name in self.names:
            tag = name.replace(".", "_")
            reg = getattr(self, f"reg__{tag}")
            g = getattr(self, f"gen__{tag}")(e).reshape(-1)
            generated[name] = g * reg + 1.0 if name.endswith(".scale") else g * reg
            l2 = l2 + (reg ** 2).sum()
        return generated, l2
