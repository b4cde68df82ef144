"""The loop of the coherent flagging cells: one caller, closed.

Each call is ``flag_waterfalls_coherent(block, predictor)`` on a 4-pol
block of the pool, already on the card, and waits for its flags on the
card (they are not copied to the host): the call that
``flag_measurement_set(method="model8")`` makes for a block. A block is
a pool entry of the traffic's ``waterfalls``, ``count`` planes viewed as
(count / 4 baselines, 4 pols, channels, times), so that each
polarisation draws its own events. The predictor is the configuration's
snapshot as ``CompiledPredictor.from_snapshot`` serves it, handed over
through ``loops/flag.py``'s :class:`Handoff`: the benchmark's
``predictor`` span around it and, for the calls drawn for the
comparison, the images it was handed and the logits it worked out.

In a traced run the loop installs the program's span recorder
(``utils.profiling.recording``) and puts the tracer's markers at both
edges of the program's spans that its readers take (``coherent.call``,
``coherent.images``, ``predict.logits``) while the profiler runs. A
program without one of them opens nothing there, and its reader falls
back (a program from before the coherent spans) or finds nothing.

The comparison (after the window): a sample of the window's calls drawn
from the seed, the first call always among them, against the reference
(``reference/coherent.py``): their images (the gap over the reference
element's magnitude, at least 1: robust-scaled RFI reaches 1e6 and more,
so an absolute gap would scale with it), their logits (the widest gap)
and their flags (exactly, wherever the reference's logit is clear of
the threshold by float32's rounding).
"""

import contextlib
import math
import time

import torch

from benchmark import coherent_counts, waterfalls
from benchmark.loops.flag import BAND, Handoff, failed_answers, snapshot_path
from benchmark.loops.flag import Loop as FlagLoop
from benchmark.reference import coherent as ref, precision
from benchmark.window import Call

__all__ = ["Loop", "readings", "failed_answers"]

POLS = 4
# the program's spans the readers take (``coherent.call``: whether the program opens the
# coherent spans at all, ``coherent_counts.images_kernels``)
READ_SPANS = ("coherent.call", "coherent.images", "predict.logits")


class ProgramMarks:
    """An ``on_edge`` for the program's span recorder: the tracer's span
    (its two markers, while the profiler runs) around each program span
    named in ``names``, under the program's name and tag."""

    def __init__(self, tracer, names):
        self.tracer, self.names, self.open = tracer, frozenset(names), {}

    def __call__(self, name, tag):
        if name not in self.names:
            return
        span = self.open.pop((name, tag), None)
        if span is None:
            self.open[name, tag] = span = self.tracer.span(name, tag)
            span.__enter__()
        else:
            span.__exit__(None, None, None)


class Loop(FlagLoop):
    """``loops/flag.py``'s closed loop (its window, its draw of the
    samples, its trace after the window) around coherent calls."""

    def __init__(self, cell):
        from rfi_toolbox_tpu_torch.io.flagging import flag_waterfalls_coherent
        from rfi_toolbox_tpu_torch.serving import CompiledPredictor
        from rfi_toolbox_tpu_torch.utils import profiling

        self.cell, self.flag = cell, flag_waterfalls_coherent
        cfg, tr = cell.config, cell.traffic
        spec = tr["waterfalls"]
        if spec["count"] % POLS:
            raise ValueError(f"{spec['count']} planes are not whole {POLS}-pol baselines")
        self.pool = [wf.view(-1, POLS, spec["channels"], spec["times"])
                     for wf, _ in waterfalls.make_pool(spec, tr["pool"], cell.seed, cell.device)]
        p = cfg["patch_size"]
        pred = CompiledPredictor.from_snapshot(snapshot_path(cell), device=cell.device,
                                               batch_size=cfg["predictor_batch"],
                                               input_shape=(p, p, cfg["model"]["in_channels"]))
        self.hand = Handoff(pred, cell.tracer)
        self._spans = contextlib.ExitStack()
        if cell.tracer.enabled:
            self._spans.enter_context(
                profiling.recording(on_edge=ProgramMarks(cell.tracer, READ_SPANS)))
        self.next = 0
        for _ in range(2):  # warm-up: every shape of the window
            self._call(self.next % len(self.pool))
            self.next += 1
        self.est = self._call(self.next % len(self.pool))[1].latency
        self.next += 1
        self.samples = []

    def _call(self, b, keep=False):
        cfg = self.cell.config
        self.hand.keep, self.hand.kept = keep, None
        t0 = time.perf_counter()
        with self.cell.tracer.span("flag_waterfalls_coherent", b):
            flags = self.flag(self.pool[b], self.hand, patch_size=cfg["patch_size"],
                              device=self.cell.device)
        t1 = time.perf_counter()
        self._sync()
        t2 = time.perf_counter()
        return flags, Call(t0, t1, t2, {"vis": self.pool[b].numel()}, {"block": b})

    def facts(self):
        cfg, m = self.cell.config, self.cell.config["model"]
        b, _, c, t = self.pool[0].shape
        p = cfg["patch_size"]
        n = b * -(-c // p) * -(-t // p)
        bs = cfg["predictor_batch"]
        return {"images_bytes": coherent_counts.images_bytes(b * POLS * c * t, n, p * p,
                                                             m["in_channels"]),
                "flops_per_call": coherent_counts.forward_flops(
                    -(-n // bs) * bs, p, m["in_channels"], m["init_features"], m["depth"])}

    def release(self):
        self._spans.close()
        return super().release()


def readings(cell, ev, control=False):
    """The numbers compared over the sampled calls (the worst of them),
    of the program or, with ``control``, of the reference in a lower
    precision put in its place (the images in bf16; the predictor in TF32
    on exact images), against the reference."""
    cfg, m = cell.config, cell.config["model"]
    p, bs = cfg["patch_size"], cfg["predictor_batch"]
    worst = {}

    def note(name, value, pick=max):
        worst[name] = pick(worst.get(name, value), value)

    def tf32(on):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    params, meta = ref.load_snapshot(snapshot_path(cell))
    thr = float(meta.get("best_threshold", cfg["threshold"]))
    cut = math.log(thr / (1 - thr))
    for _, flags, images, batches, vis4 in ev["samples"]:
        b, _, c, t = vis4.shape
        dev = vis4.device
        weights = {k: v.to(dev) for k, v in params.items()}
        run = lambda x: ref.logits(weights, x, bs, m["depth"], m["norm_groups"], m["norm_eps"])
        tf32(False)
        ref_images = ref.coherent_images(vis4, p)
        logits = run(ref_images)
        want = ref.unpatchify(torch.sigmoid(logits) > thr, b, c, t)
        margin = ref.unpatchify((logits - cut).abs(), b, c, t)
        note("min_logit_margin", float(margin.min()), min)
        note("band_pixels", int((margin < BAND).sum()))
        if control:
            images = ref.coherent_images(vis4, p, q=precision.bf16)
            tf32(True)
            got = run(ref_images)
            tf32(False)
            flags = ref.unpatchify(torch.sigmoid(got) > thr, b, c, t)
        else:
            got = torch.cat(batches)[:logits.shape[0]]
        note("images_rel_gap", float(((images - ref_images).abs()
                                      / ref_images.abs().clamp_min(1.0)).max()))
        note("logits_max_gap", float((got - logits).abs().max()))
        note("flags_differ", int(((flags != want) & (margin >= BAND)).sum()))
    return worst
