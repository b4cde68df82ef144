"""Faults planted in the program under the timed path, which the
comparison must reject: each a context manager that patches the
program's module and restores it.

- ``unchanged_state``: the optimiser step returns, leaving the state as
  it was;
- ``half_batch``: the loss is the mean over the first half of the batch;
- ``altered_label``: one label of static prep's output flipped where it
  is made;
- ``altered_flags``: each call's answer altered where it is made: the
  predictor's flags of its first patch inverted, or one flag of K5's
  wrapper flipped.

A single card exchanges nothing, so no fault of the exchange between
cards applies.
"""

import contextlib


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def unchanged_state():
    from rfi_toolbox_tpu_torch.train import trainer

    return _patched(trainer.TrainState, "apply_gradients", lambda self, grads: None)


def half_batch():
    from rfi_toolbox_tpu_torch.train import trainer

    loss = trainer.bce_dice_loss

    def half(logits, labels, group=None):
        n = logits.shape[0] // 2
        return loss(logits[:n], labels[:n], group=group)

    return _patched(trainer, "bce_dice_loss", half)


def altered_label():
    from rfi_toolbox_tpu_torch.preprocess import static_prep

    from_keep = static_prep.StaticPrep.from_keep

    def altered(self, b, keep):
        images, labels, patches, flags = from_keep(self, b, keep)
        labels[0, 0, 0] ^= 1
        return images, labels, patches, flags

    return _patched(static_prep.StaticPrep, "from_keep", altered)


@contextlib.contextmanager
def altered_flags():
    from rfi_toolbox_tpu_torch import serving
    from rfi_toolbox_tpu_torch.io import flagging

    call, mad = serving.CompiledPredictor.__call__, flagging.mad_flag_patches

    def predicted(self, images):
        out = call(self, images)
        out[0] = ~out[0]
        return out

    def flagged(patches, sigma):
        out = mad(patches, sigma)
        out[0, 0, 0] ^= True
        return out

    with _patched(serving.CompiledPredictor, "__call__", predicted), \
            _patched(flagging, "mad_flag_patches", flagged):
        yield


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch, altered_label, altered_flags)}
# the faults each loop's cells can have
BY_LOOP = {"train_static": ("unchanged_state", "half_batch", "altered_label"),
             "flag": ("altered_flags",)}
