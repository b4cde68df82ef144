"""The loop of the flagging cells: one caller, closed.

Each call is ``flag_waterfalls(block, method, sigma, patch_size,
predictor)`` on a block of the pool, already on the card, and waits for
its flags on the card (they are not copied to the host). The next call
starts when the last one's flags are ready. ``method="model"`` hands the
program the shipped snapshot's ``CompiledPredictor``, through a callable
of the benchmark's own that keeps, for the calls drawn for the
comparison, the images the program extracted and the logits its
predictor worked out from them.

The comparison (after the window): a sample of the window's calls
drawn from the seed, the first call always among them, against the
reference: their flags (exactly: the MAD's everywhere, the model's
wherever the reference's logit is clear of the threshold by float32's
rounding), and for the model their images (K4's output) and logits too.
"""

import hashlib
import math
import random
import time

import torch

from benchmark import counts, waterfalls
from benchmark.reference import extract as ref_extract, mad as ref_mad, precision, unet as ref_unet
from benchmark.window import Call, Window


class Handoff:
    """The predictor as the program receives it: a span around the call
    into the predictor layer and, when asked, the images it was handed
    and the logits it worked out from them (its ``logits``, which its
    call runs on each batch, wrapped for that call)."""

    def __init__(self, predictor, tracer):
        self.predictor, self.tracer = predictor, tracer
        self.keep, self.kept = False, None

    def __call__(self, images):
        pred = self.predictor
        if not self.keep:
            with self.tracer.span("predictor"):
                return pred(images)
        batches = []

        def logits(x):
            out = type(pred).logits(pred, x)
            batches.append(out)
            return out

        pred.logits = logits
        try:
            with self.tracer.span("predictor"):
                out = pred(images)
        finally:
            del pred.logits
        self.kept = (images, batches)
        return out


def snapshot_path(cell):
    """The configuration's snapshot, held to its recorded hash."""
    path = cell.root / cell.config["snapshot"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != cell.config["snapshot_sha256"]:
        raise RuntimeError(f"{path} is not the snapshot the configuration names")
    return path


class Loop:
    def __init__(self, cell):
        from rfi_toolbox_tpu_torch.io.flagging import flag_waterfalls
        from rfi_toolbox_tpu_torch.serving import CompiledPredictor

        self.cell, self.flag_waterfalls = cell, flag_waterfalls
        cfg, tr = cell.config, cell.traffic
        self.method = tr["method"]
        self.pool = [wf for wf, _ in waterfalls.make_pool(tr["waterfalls"], tr["pool"],
                                                          cell.seed, cell.device)]
        self.hand = None
        if self.method == "model":
            pred = CompiledPredictor.from_snapshot(snapshot_path(cell), device=cell.device,
                                                   batch_size=cfg["predictor_batch"])
            self.hand = Handoff(pred, cell.tracer)
        self.next = 0
        for _ in range(2):  # warm-up: every shape of the window
            self._call(self.next % len(self.pool))
            self.next += 1
        self.est = self._call(self.next % len(self.pool))[1].latency
        self.next += 1
        self.samples = []

    def _sync(self):
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize()

    def _call(self, b, keep=False):
        cfg = self.cell.config
        if self.hand is not None:
            self.hand.keep, self.hand.kept = keep, None
        t0 = time.perf_counter()
        with self.cell.tracer.span("flag_waterfalls", b):
            flags = self.flag_waterfalls(self.pool[b], method=self.method, sigma=cfg["mad_sigma"],
                                         patch_size=cfg["patch_size"],
                                         predictor=self.hand, device=self.cell.device)
        t1 = time.perf_counter()
        self._sync()
        t2 = time.perf_counter()
        return flags, Call(t0, t1, t2, {"vis": self.pool[b].numel()}, {"block": b})

    def run_window(self, seconds):
        n_samples = self.cell.traffic["samples"]
        rng = random.Random(self.cell.seed)
        p = n_samples / max(n_samples, seconds / self.est)
        self._sync()
        start = time.perf_counter()
        end = start + seconds
        calls = []
        while (now := time.perf_counter()) < end:
            self.cell.tracer.tick(now, end)
            b = self.next % len(self.pool)
            drawn = not calls or (len(self.samples) < n_samples and rng.random() < p)
            flags, call = self._call(b, keep=drawn)
            calls.append(call)
            if drawn:
                self.samples.append((b, flags, self.hand.kept if self.hand else (None, None)))
            self.next += 1
        if self.hand is not None:
            self.hand.keep, self.hand.kept = False, None
        close = calls[-1].ready if calls else time.perf_counter()
        self.cell.tracer.finish(self._another, self._sync)
        return Window(start, close, calls)

    def _another(self):
        """A call after the window, for a stretch traced again."""
        self._call(self.next % len(self.pool))
        self.next += 1

    def facts(self):
        cfg = self.cell.config
        m, c, t = self.pool[0].shape
        p = cfg["patch_size"]
        n = m * (c // p) * (t // p)
        out = {"vis_per_call": m * c * t, "patches_per_call": n, "px": p * p}
        if self.method == "model":
            bs = cfg["predictor_batch"]
            out["flops_per_call"] = counts.unet_forward_flops(
                -(-n // bs) * bs, p, cfg["model"]["init_features"], cfg["model"]["depth"])
        return out

    def release(self):
        ev = {"samples": [(b, flags, images, logits, self.pool[b])
                          for b, flags, (images, logits) in self.samples]}
        del self.pool, self.hand, self.samples
        return ev


# A served flag is compared where the reference's logit lies at least
# BAND from the threshold's logit: nearer, two sound float32 programs may
# cut it either way (their logits differ in the last digits by the order
# of the sums and the folded BatchNorm). The readings give the pixels so
# left out (band_pixels) and the nearest logit (min_logit_margin).
BAND = 1e-3


def _model_logits(cell, images, q=None):
    """Reference logits of (N, p, p, 3) images through the snapshot's
    UNet, in blocks of the predictor's batch; and the threshold."""
    params, stats, meta = ref_unet.load_snapshot(snapshot_path(cell))  # 7 MB, read again
    dev = images.device
    params = {k: v.to(dev) for k, v in params.items()}
    stats = {k: v.to(dev) for k, v in stats.items()}
    bs = cell.config["predictor_batch"]
    with torch.no_grad():
        logits = torch.cat([
            ref_unet.forward(params, images[i:i + bs].permute(0, 3, 1, 2).contiguous(),
                             cell.config["model"]["depth"], stats, q)
            for i in range(0, images.shape[0], bs)])
    return logits, float(meta.get("best_threshold", cell.config["threshold"]))


def readings(cell, ev, control=False):
    """The numbers compared over the sampled calls (the worst of them),
    of the program or, with ``control``, of the reference in a lower
    precision put in its place, against the reference."""
    p, sigma = cell.config["patch_size"], cell.config["mad_sigma"]
    worst = {}

    def note(name, value, pick=max):
        worst[name] = pick(worst.get(name, value), value)

    for _, flags, images, batches, wf in ev["samples"]:
        m, c, t = wf.shape
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if cell.traffic["method"] == "mad":
            want = ref_mad.waterfall_flags(wf, sigma, p)
            if control:
                flags = ref_mad.waterfall_flags(wf, sigma, p, q=precision.bf16)
            note("flags_differ", int((flags != want).sum()))
            continue
        patches = ref_extract.patchify(wf, p)
        ref_images = ref_extract.images(patches)
        logits, thr = _model_logits(cell, ref_images)
        want = ref_extract.unpatchify(torch.sigmoid(logits) > thr, m, c, t)
        margin = ref_extract.unpatchify((logits - math.log(thr / (1 - thr))).abs(), m, c, t)
        note("min_logit_margin", float(margin.min()), min)
        note("band_pixels", int((margin < BAND).sum()))
        if control:
            # the predictor in TF32 on exact images; the extraction in bf16
            images = ref_extract.images(patches, q=precision.bf16)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            got = _model_logits(cell, ref_images)[0]
            flags = ref_extract.unpatchify(torch.sigmoid(got) > thr, m, c, t)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            got = torch.cat(batches)[:logits.shape[0]]
        note("logits_max_gap", float((got - logits).abs().max()))
        note("images_max_abs", float((images - ref_images).abs().max()))
        note("flags_differ", int(((flags != want) & (margin >= BAND)).sum()))
    return worst


def failed_answers(ev, correct):
    """Answers that failed the comparison: the numbers compared are the
    worst over the sampled calls, so a failure counts against each."""
    return 0 if correct else len(ev["samples"])
