"""Training on the card: the train steps, the optimiser, and ``Trainer``.

Counterpart of ``rfi_toolbox_tpu/train/trainer.py``: ``create_train_state``,
``train_step``, ``train_steps``, ``eval_step``, ``Trainer`` (``fit``,
checkpoints, ``predict``, the device mesh), ``export_params`` and
``load_params``.

The optimiser is optax's ``chain(clip_by_global_norm(1.0),
adamw(1e-4, weight_decay=1e-5))``, written out so that its numbers
follow optax and not ``torch.optim``:

- the gradients become ``(g / norm) * max_norm`` only where the global
  norm is not below ``max_norm``, with no epsilon (``clip_grad_norm_``
  adds 1e-6);
- Adam with b1 0.9, b2 0.999 and eps 1e-8 added outside the square root
  of the bias-corrected second moment, the bias corrections ``1 -
  b**step`` computed in float32 as optax computes them;
- decoupled weight decay on the parameters before the update, scaled by
  the learning rate with the Adam step;
- a learning rate that is a schedule (``warmup_cosine_decay_schedule``,
  optax's) is evaluated at the count of updates already applied, in
  float32, as optax's ``scale_by_schedule`` evaluates it.

Images are NHWC (N, H, W, 3), labels (N, H, W). The model's conv
kernels and its activations are kept in the channels-last layout
(NHWC in memory, as the JAX package lays them out): cuDNN then runs its
NHWC kernels without transposes, and BatchNorm its channels-last
kernels. BatchNorm running statistics update in the forward of each
training step, as Flax's mutable ``batch_stats`` do. On the card,
``train_steps`` replays each step's forward and backward as one CUDA
graph (:class:`StepGraph`; the same kernels, so the same numbers), so
that the host's launches do not hold the card back.

Checkpoints are the port's own (``torch.save`` of the model's
``state_dict``, Adam's moments, the step, epoch and loss): Orbax is
JAX-only. ``export_params`` writes the JAX package's ``.npz`` inference
snapshot, which both packages' ``load_params`` read.

On a mesh (``Trainer(mesh=...)`` or ``mesh_shape=(data, model)``; one
process a device, see :mod:`rfi_toolbox_tpu_torch.parallel`) every rank
walks the same batch order and takes its rows of each batch (the whole
batch where it does not divide the ``data`` axis). The loss and the
BatchNorm statistics are those of the whole batch (all-reduced partial
sums), each rank's gradient is its rows' share, and the shares are
summed over ``data`` before the global-norm clip and AdamW. With a
``model`` axis above 1 the wide convs are tensor parallel
(``parallel.mesh.shard_params_tensor_parallel``), and the clip's norm
counts each sharded tensor once. Rank 0 writes checkpoints of the full
(gathered) state in the meshless format, so that a run restores on any
mesh.
"""

import contextlib
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..data.batched_dataset import ArrayDataset, StreamingDataset
from ..evaluation.metrics import evaluate_segmentation_batch
from ..models.convert import load_params, params_to_flax, save_params
from ..models.unet import BatchNorm, flax_init_
from ..parallel.functional import (
    all_reduce_grads,
    gather_shard,
    global_grad_norm,
    group_size,
    local_shard,
)
from ..parallel.mesh import (
    batch_placement,
    gather_tensor_parallel_state,
    make_mesh,
    shard_params_tensor_parallel,
)
from ..serving import predict_mask
from ..utils.device import resolve_device
from ..utils.profiling import span
from .losses import bce_dice_loss

__all__ = ["TrainState", "StepGraph", "Trainer", "create_train_state", "train_step",
           "train_steps", "eval_step", "export_params", "load_params",
           "warmup_cosine_decay_schedule"]

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


class TrainState:
    """A model being trained and its optimiser state.

    Attributes:
        model: the UNet, on the training device.
        params: its parameters, in ``model.parameters()`` order.
        mu, nu: Adam's first and second moments, one tensor per parameter.
        step: optimiser steps taken (a host int; no device sync).
        learning_rate: a float, or a schedule ``count -> float`` that
            :meth:`apply_gradients` evaluates at the count of updates
            already applied (e.g. :func:`warmup_cosine_decay_schedule`).
        weight_decay, clip_norm: the optimiser's other settings.
        step_graph: the :class:`StepGraph` that :func:`train_steps`
            replays on a card (None until it makes one).
    """

    def __init__(self, model, learning_rate=1e-4, weight_decay=1e-5,
                 clip_norm=1.0):
        self.model = model
        self.params = list(model.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.step = 0
        self.step_graph = None
        self.learning_rate = (learning_rate if callable(learning_rate)
                              else float(learning_rate))
        self.weight_decay = float(weight_decay)
        self.clip_norm = float(clip_norm)

    @property
    def device(self):
        return self.params[0].device

    @torch.no_grad()
    def apply_gradients(self, grads):
        """One optimiser step, in place, without a host sync."""
        lr = self.learning_rate
        if callable(lr):
            lr = lr(self.step)
        self.step += 1
        norm = global_grad_norm(grads, self.params)
        # optax: t if norm < max_norm else (t / norm) * max_norm; below the
        # threshold the divisor and the factor are both exactly 1
        below = norm < self.clip_norm
        grads = torch._foreach_div(grads, torch.where(below, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(below, 1.0, self.clip_norm))
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads),
                            alpha=1.0 - B2)
        mu_hat = torch._foreach_div(self.mu, bias_correction(B1, self.step))
        denom = torch._foreach_div(self.nu, bias_correction(B2, self.step))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)


def bias_correction(decay, step):
    """Adam's ``1 - decay**step`` as optax computes it: in float32 (the
    decay rounded to float32, a float32 power). Returned as the float
    value of that float32 number. It matches XLA's float32 power at
    most steps and is within one float32 ulp of it at the rest (for b2
    0.999: 10 of the first 557 steps differ, the first at step 168)."""
    d = torch.tensor(decay, dtype=torch.float32)
    return float(1 - d ** torch.tensor(float(step), dtype=torch.float32))


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps,
                                 end_value=0.0, exponent=1.0):
    """optax's ``warmup_cosine_decay_schedule``: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (warmup included), held
    after. Returns ``schedule(count) -> float``, the float value of the
    float32 number optax computes, with its operations in optax's order
    (the cosine is numpy's float32 one, within an ulp of XLA's)."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps "
                         f"({warmup_steps})")

    def schedule(count):
        count = int(count)
        if count < warmup_steps:  # optax's linear_schedule
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        t = f32(min(count - warmup_steps, cos_steps))  # optax's cosine_decay_schedule
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(cos_steps)))
        decayed = f32(1 - alpha) * cosine ** f32(exponent) + f32(alpha)
        return float(f32(peak_value) * decayed)

    return schedule


def create_train_state(model, seed=0, learning_rate=1e-4, weight_decay=1e-5,
                       clip_norm=1.0, device=None):
    """Put ``model`` on the device and pair it with a fresh optimiser.

    Args:
        model: the port's UNet.
        seed: int seed for Flax's initialisers (:func:`flax_init_`), or
            None to keep the model's weights (e.g. converted from a Flax
            state by ``models.params_from_flax``).
        learning_rate, weight_decay, clip_norm: the JAX defaults; the
            learning rate may be a schedule (:class:`TrainState`).
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.
    """
    dev = resolve_device(device)
    if seed is not None:
        at = next(model.parameters()).device
        flax_init_(model, torch.Generator(device=at).manual_seed(int(seed)))
    model = model.to(dev, memory_format=torch.channels_last)
    return TrainState(model, learning_rate, weight_decay, clip_norm)


def _logits(model, images):
    """(N, H, W, C) images -> (N, H, W) logits; the NCHW view of the
    images is made channels-last contiguous (a no-op for contiguous
    NHWC images)."""
    x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return model(x)[:, 0]


@contextlib.contextmanager
def batch_norm_group(model, group):
    """Within the block, ``model``'s BatchNorms take their training
    statistics over ``group``'s rows (none with ``group`` None)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


def train_step(state, images, labels, group=None):
    """One optimisation step on (B, H, W, 3) images and (B, H, W) labels.
    Updates ``state`` in place and returns ``(state, loss)``, the loss a
    0-d float32 tensor on the device (read it when needed: reading it
    waits for the card). With ``group``, the images are this rank's rows
    of a batch spread over the group's ranks: the loss and the BatchNorm
    statistics are the whole batch's, and the gradients are summed over
    the group before the update. In the ``train.step`` span, its phases
    in ``train.forward``, ``train.backward`` and ``train.optimizer``."""
    with span("train.step"):
        state.model.train()
        with batch_norm_group(state.model, group):
            with span("train.forward"):
                loss = bce_dice_loss(_logits(state.model, images), labels, group=group)
            with span("train.backward"):
                grads = list(torch.autograd.grad(loss, state.params))
                if group is not None:
                    grads = all_reduce_grads(grads, group)
        with span("train.optimizer"):
            state.apply_gradients(grads)
        return state, loss.detach()


def train_steps(state, images, labels, group=None):
    """S optimisation steps on images (S, B, H, W, 3) and labels
    (S, B, H, W); the same numbers as S :func:`train_step` calls.
    Returns ``(state, losses)`` with losses (S,) on the device.

    On a CUDA card, with no ``group`` and no tensor-parallel parameter,
    the steps go through the state's :class:`StepGraph`, made anew when
    the inputs' shapes or the model's tensors change."""
    steps = range(images.shape[0])
    if (group is not None or not images.is_cuda
            or any(getattr(p, "tp_shard", None) for p in state.params)):
        return state, torch.stack([train_step(state, images[s], labels[s], group)[1]
                                   for s in steps])
    key = StepGraph.key_of(state, images[0], labels[0])
    if state.step_graph is None or state.step_graph.key != key:
        state.step_graph = StepGraph(key, images.device)
    return state, torch.stack([state.step_graph.step(state, images[s], labels[s])
                               for s in steps])


class StepGraph:
    """A train step's forward and backward as one CUDA graph.

    Its first step is :func:`train_step`, run on a side stream (the
    warm-up that capture asks for); its second captures the logits, the
    loss and the gradients over static images and labels; every step
    from then on copies its inputs into those, replays the graph and runs
    the optimiser on the gradients the graph wrote. A replay launches
    the kernels that the eager step launches, on the same tensors, so a
    step's numbers are the eager step's; the host launches one graph in
    place of the forward's and the backward's ~600 kernels (UNet32), and
    so stays ahead of the card. In the ``train.step`` span: the replay in
    ``train.replay``, the optimiser in ``train.optimizer``.
    """

    def __init__(self, key, device):
        self.key = key
        self.stream = torch.cuda.Stream(device)
        self.warm = False
        self.graph = None

    @staticmethod
    def key_of(state, images, labels):
        """What a graph holds fixed besides its inputs' values: their
        shapes and types, and where the model's tensors live."""
        return (tuple(images.shape), images.dtype, tuple(labels.shape), labels.dtype,
                tuple(t.data_ptr() for t in state.params),
                tuple(t.data_ptr() for t in state.model.buffers()))

    def step(self, state, images, labels):
        """One optimisation step on (B, H, W, 3) images and (B, H, W)
        labels; returns the loss, a 0-d tensor on the device."""
        if not self.warm:
            self.warm = True
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                loss = train_step(state, images, labels)[1]
            torch.cuda.current_stream().wait_stream(self.stream)
            return loss
        if self.graph is None:
            self._capture(state, images, labels)
        with span("train.step"):
            state.model.train()
            with span("train.replay"):
                self.images.copy_(images)
                self.labels.copy_(labels)
                self.graph.replay()
            with span("train.optimizer"):
                state.apply_gradients(self.grads)
            return self.loss.clone()

    def _capture(self, state, images, labels):
        self.images, self.labels = torch.empty_like(images), torch.empty_like(labels)
        self.graph = torch.cuda.CUDAGraph()
        state.model.train()
        with torch.cuda.graph(self.graph, stream=self.stream):
            loss = bce_dice_loss(_logits(state.model, self.images), self.labels)
            self.grads = list(torch.autograd.grad(loss, state.params))
            self.loss = loss.detach()


@torch.no_grad()
def eval_step(state, images, labels, group=None):
    """Loss and ``sigmoid(logits) > 0.5`` masks with the running
    statistics (eval mode); the loss over ``group``'s rows when given."""
    state.model.eval()
    logits = _logits(state.model, images)
    return bce_dice_loss(logits, labels, group=group), torch.sigmoid(logits) > 0.5


def _batch_mean(values, group):
    """The mean of per-sample ``values`` over ``group``'s rows."""
    if group is None:
        return values.mean()
    total = values.sum()
    dist.all_reduce(total, group=group)
    return total / (values.numel() * group_size(group))


def _grouped(batches, k, shape=len):
    """Consecutive minibatches in lists of up to k; a change of
    ``shape(batch)`` (the batch length of index arrays; the images' shape
    of streamed (images, labels) pairs) flushes the current list, as the
    JAX ``_grouped`` does."""
    buf = []
    for b in batches:
        if buf and (len(buf) == k or shape(b) != shape(buf[0])):
            yield buf
            buf = []
        buf.append(b)
    if buf:
        yield buf


def _images_shape(batch):
    return tuple(batch[0].shape)


def _batch_indices(n, batch_size, rng=None, drop_remainder=True):
    """The JAX ``_iter_batches`` order, as index arrays: a permutation by
    ``rng`` (or 0..n-1), cut into batches, the last partial one dropped."""
    idx = rng.permutation(n) if rng is not None else np.arange(n)
    end = n - (n % batch_size) if drop_remainder and n >= batch_size else n
    return [idx[start:start + batch_size] for start in range(0, end, batch_size)]


def _as_stream(dataset):
    """A directory path or :class:`StreamingDataset` -> a
    ``StreamingDataset`` (batch files streamed with bounded host memory);
    an ``ArrayDataset``-like -> None (the in-memory path)."""
    if isinstance(dataset, StreamingDataset):
        return dataset
    if isinstance(dataset, (str, Path)):
        return StreamingDataset(dataset)
    return None


def _load_if_file(dataset):
    """A path to a single ``.npz`` or ``.pt`` dataset file loads in
    memory; batch directories and in-memory datasets pass through."""
    if isinstance(dataset, (str, Path)) and Path(dataset).is_file():
        return ArrayDataset.load_from_disk(dataset)
    return dataset


class Trainer:
    """Segmentation trainer, on one device or on a mesh of them.

    >>> trainer = Trainer(model, checkpoint_dir="ckpts")
    >>> result = trainer.fit(train_ds, val_ds, num_epochs=10, batch_size=32)

    Args:
        model: the port's UNet.
        learning_rate, weight_decay: AdamW's (the JAX defaults).
        checkpoint_dir: where ``fit`` saves checkpoints (none if None; on
            a mesh a directory every rank sees).
        mesh: a :class:`~rfi_toolbox_tpu_torch.parallel.mesh.Mesh` with a
            'data' axis (and optionally 'model' for tensor parallelism);
            every rank of the job builds its ``Trainer`` and calls ``fit``
            with the same arguments.
        mesh_shape: (data, model), or (data,): builds that mesh over the
            job's processes (``parallel.make_mesh``); exclusive with ``mesh``.
        tp_min_features: the fewest conv output channels sharded over
            'model' (narrower convs stay replicated).
        seed: seeds Flax's initialisers for a fresh state and each epoch's
            shuffle (``np.random.default_rng((seed, epoch))``, the JAX
            order); a state set on ``trainer.state`` before ``fit`` is
            trained as it is.
        device: ``None`` for the CUDA card (this rank's), or e.g. ``"cpu"``.
    """

    def __init__(self, model, learning_rate=1e-4, weight_decay=1e-5,
                 checkpoint_dir=None, mesh=None, mesh_shape=None, tp_min_features=256,
                 seed=0, device=None):
        self.model = model
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        if mesh is not None and mesh_shape is not None:
            raise ValueError("pass either mesh or mesh_shape, not both")
        self.device = resolve_device(device)
        if mesh_shape is not None:
            shape = tuple(mesh_shape) + (1,) * (2 - len(mesh_shape))  # (data,) -> (data, 1)
            mesh = make_mesh(shape=shape, axis_names=("data", "model"),
                             device_type=self.device.type)
        self.mesh = mesh
        self.tp_min_features = tp_min_features
        self.seed = seed
        self.state = None
        self.history = []

    @property
    def _tp_axis_size(self):
        return 1 if self.mesh is None else self.mesh.shape.get("model", 1)

    def _init_state(self):
        state = create_train_state(self.model, self.seed, self.learning_rate,
                                   self.weight_decay, device=self.device)
        if self._tp_axis_size > 1:
            # every rank made the same full weights from the seed; each now
            # keeps its chunk of the wide convs, and Adam's moments are
            # made on the chunks
            shard_params_tensor_parallel(state.model, self.mesh, self.tp_min_features)
            state = TrainState(state.model, self.learning_rate, self.weight_decay)
        return state

    def _shard_stacked(self, *arrays, dim=1):
        """This rank's rows (along ``dim``, the batch's) of each array, and
        the group to sum partial results over (None when the batch is
        replicated, or without a mesh)."""
        if self.mesh is None:
            return arrays, None
        pl = batch_placement(arrays[0].shape[dim], self.mesh)
        return tuple(pl.local(torch.as_tensor(a), dim) for a in arrays), pl.group

    # -- checkpoints --------------------------------------------------------
    def save_checkpoint(self, name, epoch, loss):
        """Save the state under ``checkpoint_dir / (name + ".pt")``; returns
        the path, or None without a checkpoint directory. On a mesh every
        rank calls it: the tensor-parallel chunks are gathered, rank 0
        writes the full state (the meshless format), and the ranks wait
        for the write."""
        if self.checkpoint_dir is None:
            return None
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        path = (self.checkpoint_dir / f"{name}.pt").absolute()
        st = self.state
        model, mu, nu = st.model.state_dict(), st.mu, st.nu
        if self._tp_axis_size > 1:
            shards = [getattr(p, "tp_shard", None) for p in st.params]
            model = gather_tensor_parallel_state(st.model)
            mu = [gather_shard(m, sh) for m, sh in zip(mu, shards)]
            nu = [gather_shard(v, sh) for v, sh in zip(nu, shards)]
        if self.mesh is None or dist.get_rank() == 0:
            torch.save({"model": model, "mu": mu, "nu": nu, "step": st.step,
                        "epoch": int(epoch), "loss": float(loss)}, path)
        if self.mesh is not None:
            dist.barrier()
        return path

    def latest_checkpoint(self):
        """The newest checkpoint under ``checkpoint_dir``, or None
        (``fit(resume_from="auto")``)."""
        if self.checkpoint_dir is None or not self.checkpoint_dir.exists():
            return None
        candidates = list(self.checkpoint_dir.glob("*.pt"))
        return max(candidates, key=lambda p: p.stat().st_mtime) if candidates else None

    def restore(self, path):
        """Restore the model, Adam's moments and the step from a checkpoint
        and return its epoch."""
        tree = torch.load(path, map_location=self.device, weights_only=True)
        if self.state is None:
            self.state = self._init_state()
        st = self.state
        st.model.load_state_dict(tree["model"])  # tensor-parallel convs take their chunk
        shards = [getattr(p, "tp_shard", None) for p in st.params] * 2
        with torch.no_grad():
            for dst, src, sh in zip(st.mu + st.nu, tree["mu"] + tree["nu"], shards):
                dst.copy_(local_shard(src, sh))
        st.step = int(tree["step"])
        return int(tree.get("epoch", 0))

    # -- main loop -----------------------------------------------------------
    def _tensors(self, dataset):
        """Images and labels of an in-memory dataset or a streamed
        (images, labels) minibatch as float32 tensors on the device."""
        images, labels = (dataset.images, dataset.labels) if hasattr(
            dataset, "images") else dataset
        x = torch.as_tensor(images).to(self.device, torch.float32)
        y = torch.as_tensor(labels).to(self.device, torch.float32)
        return x, y

    def _train_group(self, images, labels, group=None):
        """S minibatches stacked, images (S, B, H, W, C) and labels (S, B,
        H, W) on the device (this rank's rows, spread over ``group``):
        :func:`train_steps`, or :func:`train_step` for S = 1; returns the S
        losses."""
        if images.shape[0] > 1:
            self.state, losses = train_steps(self.state, images, labels, group)
            return list(losses)
        self.state, loss = train_step(self.state, images[0], labels[0], group)
        return [loss]

    def fit(self, train_dataset, val_dataset=None, num_epochs=10, batch_size=8,
            log_every=50, resume_from=None, fused_steps=8):
        """Train; returns ``{'best_val_loss', 'best_checkpoint',
        'final_checkpoint', 'history', 'epochs_run'}`` as the JAX ``fit``.

        Datasets are ``ArrayDataset``-likes (images (N, H, W, C), labels
        (N, H, W); numpy or tensors) or single ``.npz`` / ``.pt`` files,
        moved to the device once; or ``BatchWriter`` directories (or
        :class:`StreamingDataset` objects), streamed file by file with bounded
        host memory, each minibatch moved to the device as it arrives (the
        JAX ``StreamingDataset.iter_epoch`` minibatches, the same for the
        same rng). Each epoch shuffles by
        ``np.random.default_rng((seed, epoch))`` and drops the last
        partial batch, so a resumed run replays the uninterrupted run's
        order. Groups of up to ``fused_steps`` minibatches go to
        :func:`train_steps`. A NaN validation loss stops training.
        ``log_every`` is accepted for the JAX signature and unused, as
        there. On a mesh every rank reads the whole dataset (and streams
        every file) and keeps its rows of each minibatch; the history,
        losses and metrics of the whole batches, is the same on every rank.
        """
        del log_every
        train_dataset = _load_if_file(train_dataset)
        train_stream = _as_stream(train_dataset)
        if train_stream is None:
            images, labels = self._tensors(train_dataset)
        val = val_stream = None
        if val_dataset is not None:
            val_dataset = _load_if_file(val_dataset)
            val_stream = _as_stream(val_dataset)
            if val_stream is None:
                val = self._tensors(val_dataset)

        start_epoch = 0
        if resume_from == "auto":
            resume_from = self.latest_checkpoint()
        if resume_from is not None:
            start_epoch = self.restore(resume_from)
        elif self.state is None:
            self.state = self._init_state()

        best_val = float("inf")
        best_path = None
        train_loss = float("nan")  # a resume at num_epochs runs no epoch
        for epoch in range(start_epoch, num_epochs):
            t0 = time.perf_counter()
            rng = np.random.default_rng((self.seed, epoch))
            k = max(1, int(fused_steps))
            losses = []
            if train_stream is not None:
                batches = (self._tensors(b) for b in train_stream.iter_epoch(batch_size, rng))
                for group in _grouped(batches, k, _images_shape):
                    (x, y), rows = self._shard_stacked(torch.stack([b[0] for b in group]),
                                                       torch.stack([b[1] for b in group]))
                    losses.extend(self._train_group(x, y, rows))
            else:
                for group in _grouped(_batch_indices(len(images), batch_size, rng), k):
                    (idx,), rows = self._shard_stacked(np.stack(group))
                    idx = torch.as_tensor(idx, device=self.device)
                    losses.extend(self._train_group(images[idx], labels[idx], rows))
            train_loss = float(torch.stack(losses).mean())
            record = {"epoch": epoch + 1, "train_loss": train_loss,
                      "seconds": time.perf_counter() - t0}

            if val_dataset is not None:
                val_losses, metrics = [], []
                if val_stream is not None:
                    val_batches = (self._tensors(b) for b in val_stream.iter_epoch(batch_size))
                else:
                    val_batches = ((val[0][sel], val[1][sel]) for sel in (
                        torch.as_tensor(s, device=self.device)
                        for s in _batch_indices(len(val[0]), batch_size)))
                for bi, bl in val_batches:
                    (bi, bl), rows = self._shard_stacked(bi, bl, dim=0)
                    loss, preds = eval_step(self.state, bi, bl, rows)
                    val_losses.append(loss)
                    m = evaluate_segmentation_batch(preds, bl > 0.5)
                    metrics.append({k: float(_batch_mean(v, rows)) for k, v in m.items()})
                if not val_losses:
                    raise ValueError("validation dataset produced no batches")
                val_loss = float(torch.stack(val_losses).mean())
                record["val_loss"] = val_loss
                for k in metrics[0]:
                    record[f"val_{k}"] = float(np.mean([m[k] for m in metrics]))
                if np.isnan(val_loss):
                    self.history.append(record)
                    break
                if val_loss < best_val:
                    best_val = val_loss
                    best_path = self.save_checkpoint(
                        f"unet_rfi_epoch_{epoch + 1}", epoch + 1, val_loss)
            self.history.append(record)

        final_path = self.save_checkpoint("unet_rfi_final", num_epochs, train_loss)
        return {
            "best_val_loss": best_val,
            "best_checkpoint": str(best_path) if best_path else None,
            "final_checkpoint": str(final_path) if final_path else None,
            "history": self.history,
            "epochs_run": len(self.history),
        }

    # -- inference -----------------------------------------------------------
    @torch.no_grad()
    def predict(self, images, batch_size=32, threshold=0.5, tta=False):
        """(N, H, W) bool masks, on the trainer's device, for (N, H, W, C)
        images, with the running statistics. Every chunk, the last one too,
        is zero-padded to ``batch_size`` images, as the JAX ``predict``
        does; ``tta`` averages the probabilities of the four flips. On a
        mesh every rank predicts every image; with tensor parallelism the
        call is a collective (all ranks make it)."""
        model = self.state.model.eval()
        x = torch.as_tensor(images).to(self.device, torch.float32)
        n = x.shape[0]
        out = torch.empty((n, *x.shape[1:3]), dtype=torch.bool, device=self.device)
        for start in range(0, n, batch_size):
            chunk = x[start:start + batch_size]
            valid = chunk.shape[0]
            if valid < batch_size:
                chunk = torch.cat([chunk, chunk.new_zeros((batch_size - valid,
                                                           *chunk.shape[1:]))])
            out[start:start + valid] = predict_mask(
                lambda imgs: _logits(model, imgs), chunk, threshold, tta)[:valid]
        return out


def export_params(state_or_model, path, metadata=None):
    """Write the ``.npz`` inference snapshot of the JAX ``export_params``:
    ``params/...`` and ``batch_stats/...`` arrays keyed by the Flax
    variable paths, and ``__metadata__`` (JSON). The metadata defaults to
    the model's ``init_features``, ``norm``, ``space_to_depth`` and
    ``in_channels`` (what ``from_snapshot`` reads), updated by
    ``metadata``. Returns ``path``."""
    model = getattr(state_or_model, "model", state_or_model)
    params, stats = params_to_flax(model)
    meta = {"init_features": model.init_features, "norm": model.norm,
            "space_to_depth": model.space_to_depth, "in_channels": model.in_channels,
            **(metadata or {})}
    return save_params(path, params, stats, meta)
