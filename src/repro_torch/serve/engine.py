"""Batched serving engine with continuous batching over fixed decode slots
(counterpart of ``repro/serve/engine.py``).

The paper's online scenario (§6.3, Fig. 7) as an LM server: a fixed set
of ``n_slots`` decode slots is stepped every iteration, and a request
joins a slot the moment one frees up instead of waiting for a batch:

* one shared KV cache with the slots on its batch axis;
* per-slot prefill, the prompt fed one token per step through the same
  decode step;
* greedy decoding, EOS / max-token / cache-end eviction, FIFO admission
  (``serve/slots.py``);
* every step has the same shapes whatever the occupancy: the step's
  tokens are always an ``(n_slots, 1)`` tensor on the engine's device;
* the audio family (whisper) keeps a per-slot encoder K/V pair in
  ``state.enc_kv``, each (L, n_slots, S_enc, H, hd) in the config's
  dtype: admission encodes a request's ``frontend`` frames and copies
  them into its slot. As in the reference, ``reset_slot`` zeroes the
  caches only, so a request without a frontend cross-attends to what the
  slot's last request left there.

The model behind the step is an adapter with ``init_state`` /
``decode_step`` / ``reset_slot`` and a ``device``. The default,
``TransformerServeModel``, serves the LM zoo of ``models/transformer.py``
(every family; a vlm request is text only, as in the reference, whose
engine encodes a frontend for audio alone);
``models/xnor_lm.py::XnorLMServeModel`` plugs in the packed XNOR LM. The
reference jit-compiles the step once and donates the state; here the
step runs eagerly and the adapter updates the state in place.
``swap_params`` copies new weights into the live tensors, the counterpart
of the reference's swap without a recompile: every weight keeps its
storage.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.core.execution_plan import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.slots import SlotScheduler
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


class TransformerServeModel:
    """Default model adapter: the families of ``models/transformer.py``.

    Holds copies of ``params`` on its device (a hot-swap overwrites those,
    never the caller's tree); ``arrays`` is their flat tuple, the engine's
    ``params``, and ``decode_step`` rebuilds the tree around whatever
    tensors it is given, so weights copied in by ``ServingEngine.
    swap_params`` take effect on the next step.
    """

    def __init__(self, cfg, params: dict, *, device="cuda"):
        self.cfg = cfg
        self.family = cfg.family
        self.device = resolve_device(device)
        self._spec = _spec(params)      # structure, shapes, dtypes only
        # a hot-swap overwrites these in place: copies, never the caller's
        self.arrays = tuple(t.to(self.device, copy=True)
                            for t in tree_leaves(params))

    def init_state(self, n_slots: int, max_len: int):
        return transformer.init_serve_state(self.cfg, n_slots, max_len,
                                            self.device)

    def decode_step(self, arrays, state, tokens):
        return transformer.decode_step(
            self.cfg, tree_unflatten(self._spec, arrays), state,
            tokens)

    def encode(self, arrays, frames: torch.Tensor):
        """The audio family's encoder: (B, S_enc, D) frames → cross (K, V),
        each (L, B, S_enc, H, hd), in the frames' dtype."""
        return transformer._encode(
            self.cfg, tree_unflatten(self._spec, arrays), frames)

    def reset_slot(self, state, i: int, n_slots: int):
        """Zero slot ``i`` of every tensor of the caches, in place (each
        keeps its storage), by the reference's rule: axis 1 where it is
        the slot axis ((L, B, …): K/V, MLA's latents, the recurrent
        states, the shared block's per-application K/V and every length),
        else axis 0."""
        for t in state_tensors(state.caches):
            part = slot_part(t, i, n_slots)
            if part is not None:
                part.zero_()
        return state

    def swap_arrays(self, new_params: dict) -> tuple:
        """Check that ``new_params`` has the served tree's structure,
        shapes and dtypes, and return its leaves on the model's device for
        ``ServingEngine.swap_params``."""
        if _spec(new_params) != self._spec:
            raise ValueError(
                f"params tree differs from the served model's in structure, "
                f"shape or dtype: {_spec(new_params)} != {self._spec}")
        return tuple(t.to(self.device)
                     for t in tree_leaves(new_params))


def state_tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tuple, NamedTuple or dict state, depth first."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for sub in items for t in state_tensors(sub)]


def slot_part(t: torch.Tensor, i: int, n_slots: int) -> torch.Tensor | None:
    """Slot ``i``'s view of a state tensor by the reference's rule: axis 1
    where it has ``n_slots`` entries, else axis 0, else none."""
    if t.dim() >= 2 and t.shape[1] == n_slots:
        return t[:, i]
    if t.dim() >= 1 and t.shape[0] == n_slots:
        return t[i]
    return None


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A leaf's shape and dtype: a leaf of ``_spec``'s tree (not a tuple,
    which ``train/tree.py`` walks into)."""
    shape: tuple
    dtype: torch.dtype


def _spec(params: dict) -> dict:
    """The tree's structure with a ``LeafSpec`` a leaf."""
    return tree_map(lambda t: LeafSpec(tuple(t.shape), t.dtype), params)


class ServingEngine:
    def __init__(self, cfg, params, *, model=None, n_slots: int = 8,
                 max_len: int = 512, eos_id: int = -1, device="cuda"):
        """``params``: the model's flat weight tuple, or, with no
        ``model``, a ``models/transformer.py`` tree, which the default
        ``TransformerServeModel`` copies to ``device`` (the GPU unless
        ``device="cpu"``; raises without one)."""
        if model is None:
            model = TransformerServeModel(cfg, params, device=device)
            params = model.arrays
        self.cfg, self.params = cfg, tuple(params)
        self.n_slots, self.max_len, self.eos = n_slots, max_len, eos_id
        self.model = model
        self.device = model.device
        self.state = model.init_state(n_slots, max_len)
        if getattr(model, "family", None) == "audio":
            # per-slot encoder cross K/V, filled at admission, outside the
            # caches that reset_slot zeroes
            dt = transformer._dtype(cfg)
            shape = (cfg.n_layers, n_slots, cfg.encoder_seq, cfg.n_heads,
                     cfg.head_dim)
            self.state = self.state._replace(enc_kv=tuple(
                torch.zeros(shape, dtype=dt, device=self.device)
                for _ in range(2)))
        self.sched = SlotScheduler(n_slots)
        self._steps = 0
        self._pos = np.zeros((n_slots,), np.int64)       # tokens consumed
        self._pending: list[deque] = [deque() for _ in range(n_slots)]

    # ------------------------------------------------------------------ api
    def submit(self, prompt_tokens: list[int], max_new_tokens: int = 32,
               frontend=None) -> int:
        """Enqueue a prompt; returns the request id. ``frontend``: the
        audio family's (S_enc, D) frame embeddings (numpy or a tensor),
        encoded at admission in their own dtype."""
        if len(prompt_tokens) >= self.max_len - 1:
            # the KV cache holds max_len positions and generation needs at
            # least one; a longer prompt would run past the cache
            raise ValueError(
                f"prompt length {len(prompt_tokens)} must be < max_len-1 "
                f"({self.max_len - 1}); raise max_len or truncate the prompt")
        return self.sched.submit(list(prompt_tokens),
                                 max_new=max_new_tokens, frontend=frontend)

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        """Step until every submitted request completes, or for at most
        ``max_steps`` steps. Returns {rid: generated tokens} of the
        requests completed in this call."""
        results: dict[int, list[int]] = {}
        for _ in range(max_steps):
            if not self._admit():
                break
            self._tick(results)
        return results

    @property
    def steps_executed(self) -> int:
        return self._steps

    def swap_params(self, new_params) -> None:
        """Weight hot-swap: copy ``new_params`` (the tuple of the model's
        ``swap_arrays``) into the live weight tensors.
        Every leaf must match in shape, dtype and device; each keeps its
        storage. In-flight slots continue on the new weights from the next
        step."""
        new_params = tuple(new_params)
        if len(new_params) != len(self.params):
            raise ValueError(f"params tree structure differs: "
                             f"{len(self.params)} leaves != {len(new_params)}")
        for i, (a, b) in enumerate(zip(self.params, new_params)):
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ValueError(
                    f"params leaf {i}: shape/dtype mismatch "
                    f"{tuple(a.shape)}/{a.dtype} vs {tuple(b.shape)}/"
                    f"{b.dtype}: a swap must preserve every leaf's shape "
                    f"and dtype")
            if a.device != b.device:
                raise ValueError(f"params leaf {i}: device mismatch "
                                 f"{a.device} vs {b.device}")
        with torch.no_grad():
            for a, b in zip(self.params, new_params):
                a.copy_(b)

    # ------------------------------------------------------------- internals
    def _admit(self) -> bool:
        for i, req in self.sched.admit():
            self._pending[i] = deque(req.payload)
            self._pos[i] = 0
            self.state = self.model.reset_slot(self.state, i, self.n_slots)
            if req.frontend is not None:
                frames = torch.as_tensor(req.frontend).to(self.device)[None]
                for dst, src in zip(self.state.enc_kv,
                                    self.model.encode(self.params, frames)):
                    dst[:, i].copy_(src[:, 0])
        return self.sched.n_occupied > 0

    def _step(self, tokens: torch.Tensor) -> np.ndarray:
        logits, self.state = self.model.decode_step(self.params, self.state,
                                                    tokens)
        return torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()

    def _tick(self, results: dict[int, list[int]]) -> None:
        # the (n_slots, 1) token vector: prompt feed or last output
        toks = np.zeros((self.n_slots, 1), np.int64)
        for i, req in self.sched.occupied():
            if self._pending[i]:
                toks[i, 0] = self._pending[i][0]
            elif req.out:
                toks[i, 0] = req.out[-1]
            elif req.payload:
                toks[i, 0] = req.payload[-1]
        nxt = self._step(torch.from_numpy(toks).to(self.device))
        self._steps += 1
        for i, req in self.sched.occupied():
            if self._pending[i]:
                self._pending[i].popleft()
                self._pos[i] += 1
                if self._pending[i]:
                    continue                     # still prefilling
                # prefill just drained: nxt IS the first generated token
            req.out.append(int(nxt[i]))
            self._pos[i] += 1
            if (len(req.out) >= req.max_new or int(nxt[i]) == self.eos
                    or self._pos[i] >= self.max_len - 1):
                results[req.rid] = req.out
                self.sched.complete(i)
