"""The loop of the training cells: static prep, then the train steps.

Each iteration takes one block of the pool (waterfalls and their exact
masks), runs ``Preprocessor(waterfalls, flags=mask).create_dataset(...,
static_num_patches=K)`` and ``train_steps`` over its K // B batches, as
``bench.py:main`` does. Set-up builds the one ``TrainState`` that the
window trains: weights drawn on the card from the seed, then a first
iteration through the window's own call and feed, whose first three
steps are kept apart for the comparison, and a second to warm up.

The comparison (after the window): the first iteration's images and
labels against the reference's static prep of the same block; each of
the first three steps' loss, the first step's clipped gradient (Adam's
first moment after one step over 1 - b1) and the parameters' change
after three steps against the reference's three float32 steps from the
same weights, leaf by leaf.
"""

import time

import torch

from benchmark import counts, waterfalls
from benchmark.reference import precision, prep as ref_prep, unet as ref_unet
from benchmark.window import Call, Window

REF_STEPS = 3
B1 = ref_unet.B1


def _named(model):
    return dict(model.named_parameters())


class Loop:
    def __init__(self, cell):
        from rfi_toolbox_tpu_torch.models import UNet
        from rfi_toolbox_tpu_torch.preprocess import Preprocessor
        from rfi_toolbox_tpu_torch.train import create_train_state, train_steps

        self.Preprocessor, self.train_steps = Preprocessor, train_steps
        self.cell = cell
        cfg, tr, dev = cell.config, cell.traffic, cell.device
        m = cfg["model"]
        self.patch, self.k, self.batch = cfg["patch_size"], cfg["static_num_patches"], cfg["batch_size"]
        self.steps = self.k // self.batch
        self.pool = waterfalls.make_pool(tr["waterfalls"], tr["pool"], cell.seed, dev)
        with torch.device(dev):
            model = UNet(init_features=m["init_features"], depth=m["depth"], norm=m["norm"],
                         dtype=getattr(torch, m["dtype"]))
        shapes = ref_unet.param_shapes(m["init_features"], m["depth"])
        named = _named(model)
        if {k: tuple(v.shape) for k, v in named.items()} != shapes:
            raise RuntimeError("the program's UNet parameters differ from the configuration's")
        g = torch.Generator(device=dev).manual_seed(int(cell.seed))
        w0 = ref_unet.init_params(shapes, g, dev)
        with torch.no_grad():
            torch._foreach_copy_([named[k] for k in shapes], [w0[k] for k in shapes])
        opt = cfg["optimizer"]
        self.state = create_train_state(model, seed=None, learning_rate=opt["learning_rate"],
                                        weight_decay=opt["weight_decay"],
                                        clip_norm=opt["clip_norm"], device=dev)
        self.keep = {}
        images, labels = self._prep(0)
        names = list(_named(self.state.model))
        first = self.train_steps(self.state, images[:1], labels[:1])[1]
        mu1 = {n: mu.detach().clone() for n, mu in zip(names, self.state.mu)}
        rest = self.train_steps(self.state, images[1:REF_STEPS], labels[1:REF_STEPS])[1]
        p3 = {n: p.detach().clone() for n, p in _named(self.state.model).items()}
        if self.steps > REF_STEPS:
            self.train_steps(self.state, images[REF_STEPS:], labels[REF_STEPS:])
        self.evidence = {
            "block": 0, "w0": {k: v.cpu() for k, v in w0.items()},
            "images": images.reshape(-1, *images.shape[2:]).cpu(),
            "labels": labels.reshape(-1, *labels.shape[2:]).cpu(),
            "losses": torch.cat([first, rest]).tolist(),
            "grad1": {k: (v / (1 - B1)).cpu() for k, v in mu1.items()},
            "change3": {k: (v - w0[k]).cpu() for k, v in p3.items()},
        }
        self.next = 1
        self._iteration(self.next % len(self.pool))  # warm-up on another block
        self.next += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _prep(self, b):
        """The window's feed: static prep of pool block ``b``, as
        (steps, batch, p, p, 3) images and (steps, batch, p, p) labels."""
        wf, mask = self.pool[b]
        cfg = self.cell.config
        pre = self.Preprocessor(wf, flags=mask, device=self.cell.device)
        ds = pre.create_dataset(patch_size=self.patch, use_custom_flags=True,
                                seed=cfg["prep_seed"], static_num_patches=self.k,
                                extract=cfg["extract"])
        self.keep[b] = pre.keep
        p = self.patch
        return (ds.images.reshape(self.steps, self.batch, p, p, 3),
                ds.labels.reshape(self.steps, self.batch, p, p))

    def _iteration(self, b):
        tracer = self.cell.tracer
        t0 = time.perf_counter()
        with tracer.span("create_dataset", b):
            images, labels = self._prep(b)
        t1 = time.perf_counter()
        with tracer.span("train_steps", b):
            self.train_steps(self.state, images, labels)
        t2 = time.perf_counter()
        return Call(t0, t2, t2, {"patches": self.k, "steps": self.steps},
                    {"prep_host_s": t1 - t0, "block": b})

    def run_window(self, seconds):
        sync = torch.cuda.synchronize if self.cell.device.type == "cuda" else (lambda: None)
        sync()
        start = time.perf_counter()
        end = start + seconds
        calls = []
        while (now := time.perf_counter()) < end:
            self.cell.tracer.tick(now, end)
            calls.append(self._iteration(self.next % len(self.pool)))
            self.next += 1
        sync()
        close = time.perf_counter()
        self.cell.tracer.finish(self._another, sync)
        return Window(start, close, calls)

    def _another(self):
        """An iteration after the window, for a stretch traced again."""
        self._iteration(self.next % len(self.pool))
        self.next += 1

    def facts(self):
        """What the metric readers need beside the window and the trace."""
        cfg = self.cell.config
        h, w = self.pool[0][0].shape[-2:]
        distinct = {}
        for b, keep in self.keep.items():
            idx, _ = ref_prep.base_of(keep, h // self.patch, w // self.patch)
            distinct[str(b)] = int(torch.unique(idx).numel())
        return {"k": self.k, "px": self.patch ** 2, "steps_per_call": self.steps,
                "n_distinct": distinct,
                "flops_per_step": counts.unet_train_flops(
                    self.batch, self.patch, cfg["model"]["init_features"], cfg["model"]["depth"])}

    def release(self):
        """The evidence for the comparison; the program's state is freed."""
        ev = self.evidence
        ev["waterfalls"], ev["mask"] = (x.cpu() for x in self.pool[ev["block"]])
        del self.state, self.pool, self.evidence
        return ev


def _leaf_gaps(got, want, keep=None):
    """Each leaf's gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median
    leaf's: {leaf: gap}."""
    names = [k for k in want if keep is None or k in keep]
    ref = {k: float(want[k].double().norm()) for k in names}
    med = sorted(ref.values())[len(ref) // 2]
    return {k: abs(float(got[k].double().norm()) - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


def readings(cell, ev, control=False):
    """The numbers compared, of the program (or, with ``control``, of the
    reference in a lower precision put in its place) against the
    reference. Runs on the cell's device, in float32 with TF32 off."""
    cfg, dev = cell.config, cell.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wf, mask = ev["waterfalls"].to(dev), ev["mask"].to(dev)
    p, k, batch = cfg["patch_size"], cfg["static_num_patches"], cfg["batch_size"]
    ref_images, ref_labels, _ = ref_prep.static_prep(wf, mask, p, k, cfg["prep_seed"])
    w0 = {n: v.to(dev) for n, v in ev["w0"].items()}
    steps = REF_STEPS
    losses_r, grad_r, params_r = ref_unet.train_steps(w0, ref_images, ref_labels, steps, batch)
    change_r = {n: params_r[n] - w0[n] for n in w0}
    if control:
        images, labels, _ = ref_prep.static_prep(wf, mask, p, k, cfg["prep_seed"], q=precision.bf16)
        losses, grad, params = ref_unet.train_steps(w0, images, labels, steps, batch,
                                                    q=precision.fp8)
        change = {n: params[n] - w0[n] for n in w0}
    else:
        images, labels = ev["images"].to(dev), ev["labels"].to(dev)
        losses, grad, change = ev["losses"][:steps], ev["grad1"], ev["change3"]
    grad_norms = {n: float(v.double().norm()) for n, v in grad_r.items()}
    med = sorted(grad_norms.values())[len(grad_norms) // 2]
    moved = {n for n, v in grad_norms.items() if v >= 1e-3 * med}
    grad_gaps = _leaf_gaps({n: v.to(dev) for n, v in grad.items()}, grad_r)
    change_gaps = _leaf_gaps({n: v.to(dev) for n, v in change.items()}, change_r, moved)
    out = {
        "labels_differ": int((labels != ref_labels).sum()),
        "images_max_abs": float((images - ref_images).abs().max()),
        "grad1_leaf_gap": max(grad_gaps.values()),
        "change3_leaf_gap": max(change_gaps.values()),
        "change3_median_leaf_gap": sorted(change_gaps.values())[len(change_gaps) // 2],
        # where the worst leaves are, for the look that the limits rest on
        "grad1_worst_leaf": max(grad_gaps, key=grad_gaps.get),
        "change3_worst_leaf": max(change_gaps, key=change_gaps.get),
        "left_out_leaves": sorted(set(grad_norms) - moved),
    }
    for s, (a, b) in enumerate(zip(losses, losses_r), 1):
        out[f"loss{s}_rel_gap"] = abs(a - b) / abs(b)
    return out


def failed_answers(ev, correct):
    """Answers that failed the comparison: the set-up's steps are one."""
    return int(not correct)
