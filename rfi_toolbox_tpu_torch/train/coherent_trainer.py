"""Trainer for the coherent 8-channel pipeline, on the card.

Counterpart of ``rfi_toolbox_tpu/train/coherent_trainer.py``
(``CoherentTrainer``, ``coherent_batch`` and their helpers), the recipe
behind the shipped ``pretrained/unet*_coherent8ch.npz`` snapshots:

- each step's samples are generated on the device by the coherent
  simulator (:class:`~rfi_toolbox_tpu_torch.synth.simulator.RFISimulator`),
  8 channels = 4 polarisations x (re, im), robust-scaled per sample by
  the median and the interquartile range of all 8 channels;
- random independent time and frequency flips;
- clip-by-global-norm 1.0, then AdamW on optax's warmup-cosine schedule
  (0 -> 1e-3 over 500 steps, then to 1e-5 at the run's last step);
- an exponential moving average of the weights (decay 0.999), which is
  what ``export`` ships;
- checkpoints with the parameters, batch statistics, the EMA, Adam's
  moments and the step, so that a run continues rather than restarts.

Where the JAX trainer runs ``fused_steps`` steps in one ``lax.scan``,
this one runs them eagerly with no host sync between them. The samples
of step ``i`` come from a ``torch.Generator`` seeded by ``(seed, i)``
alone, so a resumed run continues the same stream. On a mesh (``mesh``,
data axis only; one process a device) every rank draws all of a step's
random numbers (``RFISimulator.draw``: one generator, the whole batch,
as JAX splits one key a sample over the mesh) and renders only its rows,
so the samples are those of the meshless run; the loss and the
BatchNorm statistics are the whole batch's, and the gradients are summed
over the ranks (``train.trainer.train_step``). The draws of the other
ranks' rows are each rank's extra cost. Held-out evaluation draws batch ``j`` from a
generator seeded ``start_key + j`` (the pretrained gates' convention,
with the port's own stream). Checkpoints are the port's own torch
format (Orbax is JAX-only), read with ``weights_only=True``; ``load``
takes a snapshot that either package exported.
"""

import copy
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..evaluation.metrics import evaluate_segmentation_batch
from ..models.convert import load_params, params_from_flax
from ..models.unet import UNet
from ..parallel.mesh import batch_sharding
from ..synth.simulator import RFISimulator
from ..utils.device import resolve_device
from .trainer import _logits, create_train_state, export_params
from .trainer import train_step as _train_step
from .trainer import warmup_cosine_decay_schedule

__all__ = ["CoherentTrainer", "coherent_batch", "to_8ch", "robust_scale"]

QUARTILES = (0.25, 0.5, 0.75)


def to_8ch(tf):
    """(..., 4, T, F) complex -> (..., T, F, 8) float32 in the reference's
    channel order: pol0.re, pol0.im, pol1.re, ... (coherent_trainer.py:49-56)."""
    x = torch.view_as_real(tf).movedim(-4, -2)  # (..., T, F, 4, 2)
    return x.reshape(*x.shape[:-2], 8)


def robust_scale(x, valid=None):
    """Per-sample robust scale of (N, ...) float32 ``x``: ``(x - median) /
    max(q75 - q25, 1e-12)`` over all the elements of each ``x[i]``
    (coherent_trainer.py:59-67). ``valid``, a bool tensor broadcastable
    to ``x``, leaves the elements where it is False out of the statistics,
    as ``jnp.nanmedian`` and ``jnp.nanpercentile`` do (flagging.py:201-215).

    The quantiles are ``torch.nanquantile``'s, linear. Against JAX's they
    agree on the median to an ulp and on the quartiles to an ulp (XLA
    fuses JAX's interpolation into a fused multiply-add). A row may hold
    up to 2**24 elements, ``torch.nanquantile``'s limit.
    """
    flat = x.reshape(x.shape[0], -1)
    if valid is not None:
        keep = torch.broadcast_to(valid, x.shape).reshape(flat.shape)
        flat = torch.where(keep, flat, float("nan"))
    q = torch.tensor(QUARTILES, dtype=flat.dtype, device=flat.device)
    q25, med, q75 = torch.nanquantile(flat, q, dim=1)
    shape = (-1,) + (1,) * (x.ndim - 1)
    return (x - med.view(shape)) / (q75 - q25).clamp_min(1e-12).view(shape)


def coherent_batch(generator, n, size):
    """A robust-scaled (n, size, size, 8) float32 batch and its (n, size,
    size) bool masks from the coherent simulator, on the generator's
    device (coherent_trainer.py:70-79): the held-out convention of the
    pretrained gates."""
    sim = RFISimulator(size, size, device=generator.device)
    tf, mask = sim.generate_rfi_device(n, generator)
    return robust_scale(to_8ch(tf)), mask


def _map_tensors(fn, tree):
    """``fn`` on every tensor of a dict of dicts of tensors."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stream_seed(seed, step):
    """The seed of step ``step``'s samples: a function of (seed, step)."""
    return int(np.random.SeedSequence([int(seed), 1, int(step)]).generate_state(1, np.uint64)[0])


class CoherentTrainer:
    """Train an 8-channel UNet on coherent samples generated on the device.

    >>> trainer = CoherentTrainer(init_features=24, size=256, norm="group")
    >>> trainer.fit(num_steps=36_000, checkpoint_dir="ckpts")
    >>> report = trainer.evaluate()           # held-out IoU sweep
    >>> trainer.export("unet24.npz", best_threshold=report["best_threshold"])

    Args are the JAX trainer's:
        model: the port's UNet with ``in_channels=8``; by default
            ``UNet(in_channels=8, init_features, norm, space_to_depth)``
            in ``dtype``.
        size: square sample side for training (``train_size`` in the
            exported metadata).
        learning_rate: a float or a schedule ``count -> float``; None
            builds the recipe's warmup-cosine schedule at ``fit`` time.
        ema_decay: EMA coefficient of the shipped weights (0: none).
        flips: random independent time and frequency flips a sample.
        seed: seeds the initial weights and the sample stream.
        dtype: the UNet's compute dtype; ``"auto"`` is bfloat16 on the
            card and float32 on the CPU.
        norm: ``"batch"`` (reference parity) or ``"group"`` (recommended
            for long runs: no train/eval inconsistency).
        space_to_depth: the 2x2-packed UNet variant.
        mesh: a :class:`~rfi_toolbox_tpu_torch.parallel.mesh.Mesh`; the
            batch is split over its 'data' axis, which it must divide.
        device: ``None`` for the CUDA card (this rank's), or e.g. ``"cpu"``.
    """

    def __init__(self, model=None, init_features=24, size=256, batch_size=16,
                 learning_rate=None, weight_decay=1e-5, ema_decay=0.999, flips=True,
                 seed=2, dtype="auto", mesh=None, norm="batch", space_to_depth=False,
                 device=None):
        self.device = resolve_device(device)
        if dtype == "auto":
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        if model is None:
            model = UNet(in_channels=8, init_features=init_features, norm=norm,
                         space_to_depth=space_to_depth, dtype=dtype)
        self.model = model
        self.init_features = model.init_features
        self.size = int(size)
        self.batch_size = int(batch_size)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.ema_decay = ema_decay
        self.flips = flips
        self.seed = seed
        if mesh is not None:
            ndata = mesh.shape.get("data", 1)
            if batch_size % ndata:
                raise ValueError(
                    f"batch_size={batch_size} must divide the mesh's "
                    f"'data' axis ({ndata})"
                )
        self.mesh = mesh
        self.schedule = None
        self.state = None
        self.ema_params = None
        self.sim = RFISimulator(self.size, self.size, seed=seed, device=self.device)

    @property
    def step(self):
        """Optimiser steps taken (0 before the first)."""
        return 0 if self.state is None else self.state.step

    # -- data ---------------------------------------------------------------
    def _rows(self):
        """This rank's rows of a batch, and the group its partial sums add
        up over (all rows and None without a mesh)."""
        if self.mesh is None or self.mesh.shape.get("data", 1) == 1:
            return None, None
        pl = batch_sharding(self.mesh)
        return pl, pl.group

    def sample(self, step):
        """The (x (B, size, size, 8) float32, y (B, size, size) float32)
        batch of step ``step``, drawn from a generator seeded by ``(seed,
        step)`` alone; on a mesh this rank's rows of it."""
        g = torch.Generator(device=self.device).manual_seed(_stream_seed(self.seed, step))
        rows, _ = self._rows()
        draws = self.sim.draw(self.batch_size, g)
        if rows is not None:
            draws = _map_tensors(rows.local, draws)
        tf, mask = self.sim.render(draws)
        x = robust_scale(to_8ch(tf))
        y = mask.to(torch.float32)
        if self.flips:
            for axis in (1, 2):  # time, then frequency
                flip = torch.rand(self.batch_size, generator=g, device=self.device) < 0.5
                if rows is not None:
                    flip = rows.local(flip)
                flip = flip.view(-1, 1, 1)
                x = torch.where(flip[..., None], x.flip(axis), x)
                y = torch.where(flip, y.flip(axis), y)
        return x, y

    # -- optimisation -------------------------------------------------------
    def _build_schedule(self, num_steps):
        lr = self.learning_rate
        if lr is None:
            lr = warmup_cosine_decay_schedule(0.0, 1e-3, 500, max(num_steps, 501),
                                              end_value=1e-5)
        self.schedule = lr

    def _init(self):
        self.state = create_train_state(self.model, self.seed, self.schedule,
                                        self.weight_decay, device=self.device)
        self.ema_params = [p.detach().clone() for p in self.state.params]

    @torch.no_grad()
    def _update_ema(self):
        d = self.ema_decay
        if not d:
            torch._foreach_copy_(self.ema_params, self.state.params)
            return
        # e * d + p * (1 - d), two float32 operations as in the reference
        torch._foreach_mul_(self.ema_params, d)
        torch._foreach_add_(self.ema_params, torch._foreach_mul(self.state.params, 1.0 - d))

    def train_step(self, x, y):
        """One step on a given batch, x (B, H, W, 8) and y (B, H, W) float
        tensors on the device: loss, clip, AdamW, EMA (the reference's
        ``one_step`` after its generation and flips), on the state that
        ``fit``, ``restore_checkpoint`` or ``load`` set up (on a mesh, this
        rank's rows). Returns the loss, a 0-d tensor on the device."""
        _, loss = _train_step(self.state, x, y, self._rows()[1])
        self._update_ema()
        return loss

    # -- main loop ----------------------------------------------------------
    def fit(self, num_steps, fused_steps=20, log_every=1000, checkpoint_dir=None,
            checkpoint_every=4000, callback=None):
        """Train for ``num_steps`` more steps (a resumed run continues its
        count and its sample stream). Groups of ``fused_steps`` steps run
        with no host sync; ``callback(step, mean_loss)`` fires at every log
        point; checkpoints go to ``checkpoint_dir / f"step_{step}.pt"``.
        Returns ``{'history': [{'step', 'loss', 'steps_per_sec'}, ...]}``."""
        if self.schedule is None:
            self._build_schedule(self.step + num_steps)
        if self.state is None:
            self._init()
        checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        history, losses = [], []
        t0 = time.perf_counter()
        done, next_log, next_ckpt = 0, log_every, checkpoint_every
        while done < num_steps:
            k = min(fused_steps, num_steps - done)
            for _ in range(k):
                losses.append(self.train_step(*self.sample(self.step)))
            done += k
            if done >= next_log or done >= num_steps:
                mean_loss = float(torch.stack(losses).mean())
                losses = []
                history.append({"step": self.step, "loss": mean_loss,
                                "steps_per_sec": done / (time.perf_counter() - t0)})
                if callback is not None:
                    callback(self.step, mean_loss)
                next_log = (done // log_every + 1) * log_every
            if checkpoint_dir is not None and (done >= next_ckpt or done >= num_steps):
                self.save_checkpoint(checkpoint_dir / f"step_{self.step}.pt")
                next_ckpt = (done // checkpoint_every + 1) * checkpoint_every
        return {"history": history}

    # -- evaluation ---------------------------------------------------------
    def _eval_model(self, use_ema=True):
        """A copy of the model with the EMA weights (or the raw ones) and
        the batch statistics."""
        model = copy.deepcopy(self.state.model)
        if use_ema and self.ema_params is not None:
            with torch.no_grad():
                torch._foreach_copy_(list(model.parameters()), self.ema_params)
        return model

    @staticmethod
    def _probs_fn(model, train):
        model.train(train)

        @torch.no_grad()
        def probs(x):
            return torch.sigmoid(_logits(model, x))

        return probs

    def evaluate(self, num_batches=8, eval_batch=8, start_key=10_000, thresholds=None,
                 tta=False, use_ema=True):
        """Held-out IoU sweep on batches ``start_key + j`` of
        :func:`coherent_batch` (per-sample IoU, averaged). Returns
        ``{'best_threshold', 'best_iou', 'ious'}``."""
        probs = self._probs_fn(self._eval_model(use_ema), train=False)
        return self._sweep(probs, num_batches, eval_batch, start_key, thresholds, tta)

    def _sweep(self, probs_fn, num_batches, eval_batch, start_key, thresholds, tta):
        if thresholds is None:
            thresholds = np.round(np.arange(0.2, 0.75, 0.05), 2)
        sums = {float(t): [] for t in thresholds}
        for j in range(num_batches):
            g = torch.Generator(device=self.device).manual_seed(start_key + j)
            x, gt = coherent_batch(g, eval_batch, self.size)
            p = probs_fn(x)
            if tta:
                p = (p + probs_fn(x.flip(1)).flip(1) + probs_fn(x.flip(2)).flip(2)
                     + probs_fn(x.flip(1, 2)).flip(1, 2)) / 4
            for t in sums:
                m = evaluate_segmentation_batch(p > t, gt)
                sums[t].append(float(m["iou"].mean()))
        ious = {t: float(np.mean(v)) for t, v in sums.items()}
        best_t = max(ious, key=ious.get)
        return {"best_threshold": best_t, "best_iou": ious[best_t], "ious": ious}

    def calibration_gap(self, num_batches=4, eval_batch=8, start_key=10_000,
                        thresholds=None, use_ema=True):
        """BatchNorm health check: the held-out best IoU with the running
        statistics (eval mode) minus that with each batch's own (train
        mode). Exactly 0.0 for GroupNorm models. Returns ``{'gap',
        'eval_mode', 'train_mode'}``."""
        eval_mode = self.evaluate(num_batches, eval_batch, start_key, thresholds,
                                  use_ema=use_ema)
        probs = self._probs_fn(self._eval_model(use_ema), train=True)
        train_mode = self._sweep(probs, num_batches, eval_batch, start_key, thresholds,
                                 tta=False)
        return {"gap": eval_mode["best_iou"] - train_mode["best_iou"],
                "eval_mode": eval_mode, "train_mode": train_mode}

    # -- persistence --------------------------------------------------------
    def export(self, path, best_threshold=0.5, use_ema=True, extra_meta=None):
        """Write an inference snapshot (the EMA weights by default) in the
        ``pretrained/unet*_coherent8ch.npz`` format, with the reference's
        metadata keys."""
        model = self._eval_model(use_ema)
        meta = {
            "model": "UNet",
            "init_features": self.init_features,
            "norm": model.norm,
            "space_to_depth": bool(model.space_to_depth),
            "in_channels": 8,
            "normalization": "robust_scale",
            "normalization_scope": "per_sample",
            "train_size": [self.size, self.size],
            "best_threshold": float(best_threshold),
            "steps": int(self.step),
            "ema_decay": self.ema_decay,
            **(extra_meta or {}),
        }
        return export_params(model, path, metadata=meta)

    def save_checkpoint(self, path):
        """Save parameters, batch statistics, EMA, Adam's moments and the
        step to ``path`` (a ``torch.save`` file); returns ``path``. On a
        mesh every rank calls it and rank 0 writes."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        st = self.state
        if self.mesh is None or dist.get_rank() == 0:
            torch.save({"model": st.model.state_dict(), "mu": st.mu, "nu": st.nu,
                        "ema_params": self.ema_params, "step": st.step}, path)
        if self.mesh is not None:
            dist.barrier()
        return path

    def restore_checkpoint(self, path, num_steps_hint=None):
        """Restore a :meth:`save_checkpoint` file and return its step.
        ``num_steps_hint`` rebuilds the default schedule for the run's
        planned total (36 000 if not given)."""
        if self.schedule is None:
            self._build_schedule(num_steps_hint or 36_000)
        if self.state is None:
            self._init()
        tree = torch.load(path, map_location=self.device, weights_only=True)
        st = self.state
        st.model.load_state_dict(tree["model"])
        with torch.no_grad():
            torch._foreach_copy_(st.mu + st.nu + self.ema_params,
                                 tree["mu"] + tree["nu"] + tree["ema_params"])
        st.step = int(tree["step"])
        return st.step

    @classmethod
    def load(cls, path, **kwargs):
        """A trainer around an exported inference snapshot (either
        package's ``export``), its weights converted by
        ``models.convert``; a fresh optimiser (prefer
        :meth:`restore_checkpoint` to continue a run)."""
        params, stats, meta = load_params(path)
        size = int(meta.get("train_size", [256, 256])[0])
        kwargs.setdefault("norm", meta.get("norm", "batch"))
        kwargs.setdefault("space_to_depth", bool(meta.get("space_to_depth", False)))
        trainer = cls(init_features=meta["init_features"], size=size, **kwargs)
        trainer._build_schedule(36_000)
        trainer._init()
        model = trainer.state.model
        model.load_state_dict(params_from_flax(params, stats, model))
        trainer.ema_params = [p.detach().clone() for p in trainer.state.params]
        return trainer
