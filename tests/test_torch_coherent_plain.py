"""The port's coherent flagging path (``flag_waterfalls_coherent``,
``coherent_images``, a GroupNorm UNet through ``CompiledPredictor``'s
``"k7_nhwc"`` route) against the plain reference ``tests/plain_coherent.py``
(plain torch, no kernel or module of the port), on the CPU at a small
size with seeded random weights; and the path's ``coherent.*`` spans.

Tolerances:

- images: the gap over the larger of the reference element's magnitude
  and 1 within 1e-6. The two sides take the same linear quantiles in
  float32 (the port by ``torch.nanquantile``, the reference by a sort and
  the interpolation written out), which agree to an ulp of the statistic
  (``torch.lerp`` takes the weight's complement above 0.5), so an image
  moves by an ulp of its own magnitude plus an ulp of the median over the
  IQR; the RFI here reaches 1e5 after the scale, so absolute gaps would
  scale with it;
- logits: within 1e-4 of the reference's, relative to the largest (at
  least 1): float32 convolutions summed in another order and GroupNorm's
  statistics (the port's ``group_norm`` against a mean and a biased
  variance written out) move a logit by a few ulps of the activations it
  sums;
- flags: equal wherever the reference's logit lies 1e-3 or more from the
  threshold's logit, the benchmark's band; the threshold is the median
  logit's probability, so that both classes are there.
"""

import functools
import math
import threading

import pytest
import torch

from rfi_toolbox_tpu_torch.io import flagging
from rfi_toolbox_tpu_torch.io.flagging import coherent_images, flag_waterfalls_coherent
from rfi_toolbox_tpu_torch.models import UNet
from rfi_toolbox_tpu_torch.serving import CompiledPredictor
from rfi_toolbox_tpu_torch.utils import profiling
from rfi_toolbox_tpu_torch.utils.profiling import recording

import plain_coherent as plain

P = 32  # patch side
BATCH = 12  # the predictor's batch: the last forward of each case is padded
BAND = 1e-3
SHAPES = {"divisible": (64, 256), "ragged": (100, 256)}


def _vis4(c, t, seed=11):
    """(2, 4, c, t) complex64 waterfalls: |noise| 1 +- 0.1 with a random
    phase, each polarisation with its own RFI stripe, burst and block of
    1e3-1e5."""
    g = torch.Generator().manual_seed(seed)
    amp = 1 + 0.1 * torch.randn((2, 4, c, t), generator=g)
    for b in range(2):
        for k in range(4):
            rfi = lambda: float(10 ** (3 + 2 * torch.rand((), generator=g)))
            ch = int(torch.randint(0, c - 3, (), generator=g))
            ti = int(torch.randint(0, t - 4, (), generator=g))
            amp[b, k, ch:ch + 2, :] += rfi()
            amp[b, k, :, ti:ti + 3] += rfi()
            amp[b, k, c // 3:c // 3 + 9, t // 2:t // 2 + 12] += rfi()
    phase = 2 * math.pi * torch.rand((2, 4, c, t), generator=g)
    return torch.polar(amp, phase)


@functools.cache
def _model():
    """UNet(8, 8 channels in, GroupNorm) with seeded random weights: the
    convs' at 1 / sqrt(fan in), GroupNorm's scales around 1 and shifts
    around 0, so that every parameter enters the comparison."""
    model = UNet(in_channels=8, init_features=8, norm="group").eval()
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if ".norm" in name:
                p.copy_(1 + 0.2 * r if name.endswith("weight") else 0.2 * r)
            else:
                fan_in = p[0].numel() if p.ndim > 1 else 1
                p.copy_(r / math.sqrt(fan_in) if p.ndim > 1 else 0.1 * r)
    return model


@functools.cache
def _case(shape):
    """The port's and the reference's images, logits and flags of one
    shape, and the reference's logits unpatchified."""
    c, t = SHAPES[shape]
    vis4 = _vis4(c, t)
    model = _model()
    params = {k: v.detach() for k, v in model.state_dict().items()}
    ref_images = plain.coherent_images(vis4, P)
    ref_logits = plain.logits(params, ref_images, BATCH)
    thr = float(torch.sigmoid(ref_logits.median()))
    pred = CompiledPredictor(model, input_shape=(P, P, 8), batch_size=BATCH, threshold=thr,
                             device="cpu")
    assert pred.route == "k7_nhwc" and not pred.folded
    got_images = coherent_images(vis4, P)
    got_logits = torch.cat([pred.logits(got_images[i:i + BATCH])
                            for i in range(0, got_images.shape[0], BATCH)])
    got_flags = flag_waterfalls_coherent(vis4, pred, patch_size=P, device="cpu")
    ref_flags, ref_z = plain.flags(params, vis4, P, thr, BATCH)
    return {"vis4": vis4, "pred": pred, "thr": thr, "images": (got_images, ref_images),
            "logits": (got_logits, ref_logits), "flags": (got_flags, ref_flags), "z": ref_z}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_images_match_the_plain_reference(shape):
    got, ref = _case(shape)["images"]
    assert got.shape == ref.shape == (2 * (-(-SHAPES[shape][0] // P)) * (SHAPES[shape][1] // P),
                                      P, P, 8)
    assert ref.abs().max() > 1e4  # the RFI survives the scale
    gap = ((got - ref).abs() / ref.abs().clamp_min(1.0)).max()
    assert gap <= 1e-6, float(gap)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_logits_match_the_plain_reference(shape):
    got, ref = _case(shape)["logits"]
    assert got.shape == ref.shape
    scale = max(float(ref.abs().max()), 1.0)
    gap = (got - ref).abs().max() / scale
    assert gap <= 1e-4, float(gap)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_flags_match_the_plain_reference(shape):
    case = _case(shape)
    got, ref = case["flags"]
    c, t = SHAPES[shape]
    assert got.shape == ref.shape == (2, c, t) and got.dtype == torch.bool
    margin = (case["z"] - math.log(case["thr"] / (1 - case["thr"]))).abs()
    clear = margin >= BAND
    assert clear.float().mean() > 0.99
    assert torch.equal(got[clear], ref[clear])
    assert 0.2 < ref.float().mean() < 0.8


# -- the coherent.* spans ------------------------------------------------------------------


def _tree(edges):
    """[(name, enclosing span's name)] in opening order, from (name, tag)
    edges of one thread; every span closed."""
    stack, tree = [], []
    for name, tag in edges:
        if stack and stack[-1] == (name, tag):
            stack.pop()
        else:
            tree.append((name, stack[-1][0] if stack else None))
            stack.append((name, tag))
    assert not stack
    return tree


def test_the_coherent_spans_nest_under_one_tag():
    case = _case("ragged")
    edges = []
    with recording(on_edge=lambda name, tag: edges.append((name, tag))) as rec:
        flags = flag_waterfalls_coherent(case["vis4"], case["pred"], patch_size=P, device="cpu")
    n_forwards = -(-case["images"][0].shape[0] // BATCH)
    assert _tree(edges) == ([("coherent.call", None), ("coherent.images", "coherent.call"),
                             ("coherent.scale", "coherent.images"),
                             ("coherent.predict", "coherent.call"),
                             ("predict", "coherent.predict")]
                            + [("predict.logits", "predict"),
                               ("predict.nhwc", "predict.logits")] * n_forwards
                            + [("coherent.unpatchify", "coherent.call")])
    assert len({s.tag for s in rec.spans}) == 1
    assert all(s.end is not None and s.end >= s.start for s in rec.spans)
    assert torch.equal(flags, case["flags"][0])  # the same answer as with spans off


def test_off_the_coherent_spans_are_the_null_context(monkeypatch):
    opened = []

    def spy(name):
        s = profiling.span(name)
        opened.append((name, s))
        return s

    monkeypatch.setattr(flagging, "span", spy)
    case = _case("divisible")
    assert profiling._recorder is None
    flag_waterfalls_coherent(case["vis4"], case["pred"], patch_size=P, device="cpu")
    assert [n for n, _ in opened] == ["coherent.call", "coherent.images", "coherent.scale",
                                      "coherent.predict", "coherent.unpatchify"]
    assert all(s is profiling._NULL for _, s in opened)


def test_the_spans_of_two_threads_keep_their_own_calls():
    case = _case("divisible")
    edges = {}

    def on_edge(name, tag):
        edges.setdefault(threading.get_ident(), []).append((name, tag))

    with recording(on_edge=on_edge):
        threads = [threading.Thread(target=flag_waterfalls_coherent,
                                    args=(case["vis4"], case["pred"]),
                                    kwargs={"patch_size": P, "device": "cpu"})
                   for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and len(edges) == 2
    roots = set()
    for per_thread in edges.values():
        tree = _tree(per_thread)
        assert tree[0] == ("coherent.call", None) and tree[-1][0] == "coherent.unpatchify"
        assert len({tag for _, tag in per_thread}) == 1
        roots |= {tag for _, tag in per_thread}
    assert len(roots) == 2


def test_the_reference_imports_plain_torch_alone():
    """``plain_coherent`` re-exports the benchmark's reference, which
    imports plain torch, numpy and the standard library alone."""
    import ast

    def imported(path):
        tree = ast.parse(open(path).read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        return names | {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}

    assert imported(plain.__file__) == {"torch", "benchmark.reference",
                                        "benchmark.reference.coherent"}
    assert imported(plain.coherent_images.__code__.co_filename) == {
        "json", "math", "numpy", "torch", "torch.nn.functional"}
