"""Training SOLOLite on instance batches generated on the card.

Counterpart of ``rfi_toolbox_tpu/train/instance_trainer.py``
(``make_instance_train_step``, ``make_instance_fused_steps``,
``InstanceTrainer``), the recipe behind the shipped
``pretrained/sololite_synthetic.npz``:

- each step's batch of complex patches and per-event instance masks is
  generated on the device (``synth.make_instance_sample_generator``),
  optionally with real patches mixed in as unlabelled negatives;
- the 3-channel ImageNet-normalised images come from K4
  (``ops.fused_extract_channels``) on the card, its plain version on the
  CPU, in the step and in evaluation alike;
- the SOLOLite forward and ``solo_loss`` (focal category loss + Dice
  mask loss), then clip-by-global-norm 1.0 and AdamW (``TrainState``'s
  optax-equivalent chain) at a float or a schedule, in float32.

Where the JAX trainer runs ``fused_steps`` steps in one ``lax.scan``,
this one runs them eagerly with no host sync between them, with the
same numbers as one step at a time. On a mesh (``mesh`` or
``mesh_shape``, data axis only; one process a device) every rank
generates each step's whole batch from the step's generator and keeps
its rows (the other rows' generation is each rank's extra cost):
the positive counts of ``solo_loss`` are the batch's, and the gradients
are summed over the ranks. The samples of step ``i`` come from a
``torch.Generator`` seeded by ``(seed, i)`` alone (the JAX
``fold_in(base, step)`` with the port's own stream), so chunked ``fit``
calls and restored runs continue the stream. Checkpoints are the port's
own torch format (Orbax is JAX-only), read with ``weights_only=True``;
``save`` writes, and ``load`` reads, the JAX package's snapshot.
"""

import math
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import ops
from ..models.convert import save_params, sololite_from_snapshot, sololite_to_flax
from ..models.instance import SOLOLite, solo_decode, solo_loss
from ..parallel.functional import all_reduce_grads
from ..parallel.mesh import batch_placement, make_mesh, shard_batch
from ..synth.sample import make_instance_sample_generator
from ..utils.device import resolve_device
from .coherent_trainer import _stream_seed
from .trainer import create_train_state

__all__ = ["InstanceTrainer", "make_instance_train_step", "make_instance_fused_steps"]

DEFAULT_RFI_CONFIG = {
    "narrowband_persistent": {"count": [1, 3]},
    "broadband_persistent": {"count": [0, 2]},
    "narrowband_bursty": {"count": [0, 2]},
    "frequency_sweep": {"count": [0, 1]},
}


def make_instance_train_step(mask_loss_stride=2, max_positive_cells=16, group=None):
    """A step ``(state, patches, inst_masks, inst_classes, inst_valid) ->
    (state, loss, parts)`` for SOLOLite on complex (B, p, p) patches and
    their instance targets: the extraction (K4, which on a CPU tensor is
    its plain version), the forward, :func:`solo_loss` and one optimiser
    update of ``state`` (a ``TrainState``), in place, without a host
    sync. ``loss`` and the ``parts`` are 0-d tensors on the device.
    ``max_positive_cells`` caps the positive cells of the Dice term (the
    loss reports ``dropped_mask_cells`` when it truncates). With
    ``group``, each batch is this rank's rows of one spread over the
    group's ranks: the loss is the whole batch's and the gradients are
    summed over the group."""

    def step(state, patches, inst_masks, inst_classes, inst_valid):
        images = ops.fused_extract_channels(patches.contiguous())
        loss, parts = solo_loss(state.model(images), inst_masks, inst_classes, inst_valid,
                                mask_loss_stride=mask_loss_stride,
                                max_positive_cells=max_positive_cells, group=group)
        grads = list(torch.autograd.grad(loss, state.params))
        if group is not None:
            grads = all_reduce_grads(grads, group)
        state.apply_gradients(grads)
        return state, loss.detach(), {k: v.detach() for k, v in parts.items()}

    return step


def _group(batch_size, mesh):
    """The group a batch's partial sums add up over: None without a mesh,
    or where the batch does not divide its data axis (replicated)."""
    return None if mesh is None else batch_placement(batch_size, mesh).group


def make_instance_fused_steps(sample_fn, batch_size, mask_loss_stride=2,
                              max_positive_cells=16, mesh=None):
    """K steps with their batch generation, queued with no host sync:
    ``(state, generators) -> (state, losses (K,), last_parts)``, one step
    a ``torch.Generator``, each drawing its batch of ``batch_size`` from
    ``sample_fn`` (``make_instance_sample_generator``'s). The numbers are
    K :func:`make_instance_train_step` steps' on the same draws. With
    ``mesh`` (a 'data' axis) each rank keeps its rows of each batch."""
    one_step = make_instance_train_step(mask_loss_stride, max_positive_cells,
                                        _group(batch_size, mesh))

    def steps(state, generators):
        losses, parts = [], None
        for g in generators:
            batch = sample_fn(batch_size, g)
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            state, loss, parts = one_step(state, batch["waterfall"], batch["inst_masks"],
                                          batch["inst_classes"], batch["inst_valid"])
            losses.append(loss)
        return state, torch.stack(losses), parts

    return steps


class InstanceTrainer:
    """Train SOLOLite on instance batches generated on the card.

    >>> trainer = InstanceTrainer(patch_size=128, batch_size=64)
    >>> result = trainer.fit(num_steps=100, fused_steps=10)

    Args are the JAX trainer's but ``use_pallas`` (K4 runs on the card,
    its plain version on the CPU):
        model: a SOLOLite; by default ``SOLOLite(num_classes=6,
            grid_size=max(patch_size // 16, 4))``.
        rfi_config: the event mix (default: 1-3 narrowband persistent,
            0-2 broadband persistent, 0-2 narrowband bursty, 0-1 sweeps).
        learning_rate: a float or a schedule ``count -> float`` (e.g.
            ``train.warmup_cosine_decay_schedule(1e-5, 8e-4, 500, total,
            end_value=1e-5)``, the shipped recipe's).
        seed: seeds Flax's initialisers, the sample stream and the
            real-patch draws.
        mask_loss_stride, max_positive_cells: :func:`solo_loss`'s.
        noise_level, rfi_power_min, rfi_power_max: the generator's.
        mesh: a :class:`~rfi_toolbox_tpu_torch.parallel.mesh.Mesh` whose
            'data' axis splits each batch.
        mesh_shape: builds a data-only mesh of ``mesh_shape[0]``
            processes (the other axes must be 1); exclusive with ``mesh``.
        device: ``None`` for the CUDA card (this rank's), or e.g. ``"cpu"``.
    """

    def __init__(self, model=None, patch_size=128, batch_size=64, rfi_config=None,
                 learning_rate=1e-3, weight_decay=1e-5, seed=0, mask_loss_stride=2,
                 max_positive_cells=16, noise_level=1.0, rfi_power_min=1000.0,
                 rfi_power_max=10000.0, mesh=None, mesh_shape=None, device=None):
        self.device = resolve_device(device)
        self.model = model if model is not None else SOLOLite(
            num_classes=6, grid_size=max(patch_size // 16, 4))
        if mesh is not None and mesh_shape is not None:
            raise ValueError("pass either mesh or mesh_shape, not both")
        if mesh_shape is not None:
            shape = tuple(mesh_shape)
            if len(shape) > 1 and math.prod(shape[1:]) != 1:
                raise ValueError(
                    "InstanceTrainer parallelism is data-only; "
                    f"mesh_shape {shape} implies non-data axes"
                )
            mesh = make_mesh(shape=(shape[0],), axis_names=("data",),
                             device_type=self.device.type)
        self.mesh = mesh
        self.patch_size = int(patch_size)
        self.batch_size = int(batch_size)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.seed = seed
        self._sample_fn = make_instance_sample_generator(
            patch_size, patch_size,
            rfi_config=DEFAULT_RFI_CONFIG if rfi_config is None else rfi_config,
            noise_level=noise_level, rfi_power_min=rfi_power_min,
            rfi_power_max=rfi_power_max, device=self.device)
        self._step = make_instance_train_step(mask_loss_stride, max_positive_cells,
                                              _group(self.batch_size, mesh))
        self._fused = make_instance_fused_steps(self._sample_fn, self.batch_size,
                                                mask_loss_stride, max_positive_cells, mesh)
        self.state = None

    @property
    def step(self):
        """Optimiser steps taken (0 before the first): the global step
        the sample stream is keyed on."""
        return 0 if self.state is None else self.state.step

    def _init(self, keep_weights=False):
        """The optimiser state around the model on the device, the model
        given Flax's initial weights from ``seed`` unless ``keep_weights``."""
        self.state = create_train_state(self.model, None if keep_weights else self.seed,
                                        self.learning_rate, self.weight_decay,
                                        device=self.device)
        self.model = self.state.model

    # -- data ---------------------------------------------------------------
    def _generator(self, step):
        return torch.Generator(device=self.device).manual_seed(_stream_seed(self.seed, step))

    def generate_batch(self, generator):
        """One instance batch drawn from ``generator`` (on the trainer's
        device): the dict of ``make_instance_sample_generator``."""
        return self._sample_fn(self.batch_size, generator)

    def sample(self, step):
        """The batch of global step ``step``: a function of ``(seed, step)``."""
        return self.generate_batch(self._generator(step))

    # -- main loop ----------------------------------------------------------
    def fit(self, num_steps=100, log_every=20, real_patches=None, real_fraction=0.0,
            fused_steps=1):
        """Train for ``num_steps`` more steps; optionally mix in real patches.

        Args:
            real_patches: optional (M, p, p) complex patches (numpy or a
                tensor), mixed in as unlabelled negatives: the first
                ``int(batch_size * real_fraction)`` samples of each batch
                are replaced by patches drawn with
                ``np.random.default_rng(seed)``, their instances invalid.
            fused_steps: with K > 1 and no real-patch mixing, steps run in
                groups of K with no host sync (the same numbers); log
                records then land at the first group boundary at or after
                each ``log_every`` multiple.

        Returns ``{'history': [{'step', 'loss', 'cate_loss', 'mask_loss',
        'steps_per_sec'} (+ 'dropped_mask_cells' where the cap truncated),
        ...]}``, 'step' counted from the start of this call; a second call,
        or a run restored by :meth:`restore_checkpoint`, continues the
        sample stream.
        """
        if self.state is None:
            self._init()
        rng = np.random.default_rng(self.seed)
        mix = real_patches is not None and real_fraction > 0
        n_real = int(self.batch_size * real_fraction) if mix else 0
        real = torch.as_tensor(real_patches) if n_real else None
        history = []

        def log(step_i, loss, parts):
            rec = {"step": step_i, "loss": float(loss),  # the read waits for the card
                   "cate_loss": float(parts["cate_loss"]),
                   "mask_loss": float(parts["mask_loss"]),
                   "steps_per_sec": step_i / (time.perf_counter() - t0)}
            dropped = int(parts["dropped_mask_cells"])
            if dropped:
                rec["dropped_mask_cells"] = dropped
            history.append(rec)

        t0 = time.perf_counter()
        step_i, next_log = 0, log_every
        while step_i < num_steps:
            if fused_steps > 1 and not mix and num_steps - step_i >= fused_steps:
                gens = [self._generator(self.step + i) for i in range(fused_steps)]
                self.state, losses, parts = self._fused(self.state, gens)
                loss = losses[-1]
                step_i += fused_steps
            else:
                batch = self.sample(self.step)
                patches, valid = batch["waterfall"], batch["inst_valid"]
                if n_real:
                    sel = torch.from_numpy(rng.integers(0, len(real), n_real))
                    patches, valid = patches.clone(), valid.clone()
                    patches[:n_real] = real[sel.to(real.device)].to(patches.device)
                    valid[:n_real] = False
                batch = {**batch, "waterfall": patches, "inst_valid": valid}
                if self.mesh is not None:
                    batch = shard_batch(batch, self.mesh)
                self.state, loss, parts = self._step(self.state, batch["waterfall"],
                                                     batch["inst_masks"],
                                                     batch["inst_classes"],
                                                     batch["inst_valid"])
                step_i += 1
            if step_i >= next_log or step_i >= num_steps:
                log(step_i, loss, parts)
                next_log = (step_i // log_every + 1) * log_every
        return {"history": history}

    # -- inference ----------------------------------------------------------
    @torch.no_grad()
    def predict(self, images, score_thresh=0.3, full_resolution=True, mask_thresh=0.5,
                nms_sigma=2.0):
        """Decode instances for (N, p, p, 3) float images (a tensor or
        numpy), in one batch on the trainer's device. Returns a list of
        per-image dicts of numpy arrays: ``masks`` (S², p, p) bool (at the
        mask head's p/4 unless ``full_resolution``), ``scores`` (S²,)
        decayed by Matrix-NMS (``nms_sigma``), ``classes`` (S²,).
        ``mask_thresh`` is the sigmoid cut of the mask logits. The trainer
        must have been trained, restored or loaded."""
        images = torch.as_tensor(images).to(self.device, torch.float32)
        out_size = tuple(images.shape[1:3]) if full_resolution else None
        out = self.model.eval()(images)
        dec = solo_decode(out, score_thresh=score_thresh, mask_thresh=mask_thresh,
                          nms_sigma=nms_sigma, out_size=out_size)
        dec = {k: v.cpu().numpy() for k, v in dec.items()}
        return [{k: v[i] for k, v in dec.items()} for i in range(len(images))]

    # -- persistence --------------------------------------------------------
    def save_checkpoint(self, path):
        """Save the parameters, Adam's moments and the step to ``path`` (a
        ``torch.save`` file); returns ``path``. On a mesh every rank calls
        it and rank 0 writes."""
        if self.state is None:
            raise ValueError("nothing to checkpoint; train or _init first")
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        st = self.state
        if self.mesh is None or dist.get_rank() == 0:
            torch.save({"model": st.model.state_dict(), "mu": st.mu, "nu": st.nu,
                        "step": st.step}, path)
        if self.mesh is not None:
            dist.barrier()
        return path

    def restore_checkpoint(self, path):
        """Restore a :meth:`save_checkpoint` file; returns its step."""
        if self.state is None:
            self._init()
        tree = torch.load(path, map_location=self.device, weights_only=True)
        st = self.state
        st.model.load_state_dict(tree["model"])
        with torch.no_grad():
            torch._foreach_copy_(st.mu + st.nu, tree["mu"] + tree["nu"])
        st.step = int(tree["step"])
        return st.step

    def save(self, path):
        """Write an inference snapshot (parameters and the JAX package's
        metadata keys), which either package's ``load`` reads."""
        m = self.model
        return save_params(path, sololite_to_flax(m), {}, {
            "model": "SOLOLite", "num_classes": m.num_classes, "grid_size": m.grid_size,
            "embed_dim": m.embed_dim, "features": m.features,
            "space_to_depth": bool(m.space_to_depth), "patch_size": self.patch_size,
        })

    @classmethod
    def load(cls, path, **kwargs):
        """A trainer around a snapshot of either package's ``save`` (e.g.
        ``pretrained/sololite_synthetic.npz``), with a fresh optimiser."""
        model, meta = sololite_from_snapshot(path)
        trainer = cls(model=model, patch_size=meta["patch_size"], **kwargs)
        trainer._init(keep_weights=True)
        return trainer
