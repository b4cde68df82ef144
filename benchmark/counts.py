"""The benchmark's frozen yardstick: peaks, the bytes each port kernel
must move, the operations of a UNet step, and the classes of kernel
names.

These are copies, kept here so that a change to the program cannot
change what it is measured against:

- the peaks and the byte bound: ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
  ``bound``; the bytes behind its kernel table);
- the operation count: ``rfi_toolbox_tpu_torch/train/flops.py``
  (``bench.py:unet_train_flops_analytic``);
- the kernel classes: ``tools/torch_train_profile.py`` (``CLASSES``).

Every function takes the shapes the cell actually runs.
"""

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
# the fastest float32-accurate product rate: 3xTF32 on the tensor cores
# (three TF32 products each), as chip_smoke.py's conv bounds take it
F32_ACCURATE_FLOPS_PER_S = TF32_FLOPS_PER_S / 3


def bound_ms(n_bytes):
    """The least milliseconds the card takes to move ``n_bytes`` once."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def k1_bytes(n_distinct, k, px):
    """K1 (gather + extraction on the base patches): each of the
    ``n_distinct`` selected base patches of ``px`` complex64 pixels read
    once, and for each of the ``k`` outputs its two int32 indices read and
    its three float32 planes written."""
    return n_distinct * px * 8 + k * (2 * 4 + 3 * 4 * px)


def k3_identity_bytes(k, px):
    """K3's identity mode (the 'auto' route's variant transform): the
    ``k`` outputs' three float32 planes read and written as images, and
    their int64 variant read."""
    return 2 * 3 * 4 * k * px + 8 * k


def k4_bytes(n, px):
    """K4 (3-channel extraction): ``n`` complex64 patches of ``px``
    pixels read, three float32 channels written."""
    return n * px * (8 + 12)


def k5_bytes(n, px):
    """K5 (MAD flags): ``n`` complex64 patches of ``px`` pixels read, one
    bool flag a pixel written."""
    return n * px * (8 + 1)


def unet_forward_macs(hw=128, in_ch=3, f=32, depth=4, out_ch=1):
    """Multiply-adds of one image through the ``space_to_depth=False``
    UNet: its 3x3 convs, 2x2 up-convs and 1x1 head, taps on the zero
    padding included, as ``train/flops.py`` counts them."""
    macs = 0
    h = hw
    c_in = in_ch
    for i in range(depth):  # encoder DoubleConvs
        c = f * 2 ** i
        macs += h * h * 9 * (c_in * c + c * c)
        c_in = c
        h //= 2
    c = f * 2 ** depth  # bottleneck
    macs += h * h * 9 * (c_in * c + c * c)
    c_in = c
    for i in reversed(range(depth)):  # decoder stages
        co = f * 2 ** i
        h *= 2
        macs += h * h * c_in * co  # 2x2 stride-2 up-conv
        macs += h * h * 9 * (2 * co * co + co * co)  # concat DoubleConv
        c_in = co
    macs += hw * hw * f * out_ch  # final 1x1
    return macs


def unet_train_flops(batch, hw=128, f=32, depth=4):
    """Operations of one train step: the convolutions' multiply-adds x 2
    x 3 (forward, input gradient, weight gradient); norms, activations,
    pooling and the optimiser are left out."""
    return 6 * unet_forward_macs(hw, 3, f, depth) * batch


def unet_forward_flops(batch, hw=128, f=16, depth=4):
    """Operations of one forward of ``batch`` images (2 a multiply-add)."""
    return 2 * unet_forward_macs(hw, 3, f, depth) * batch


# first match wins, on the lower-cased kernel name
KERNEL_CLASSES = (
    ("port kernels", ("cluster_extract", "group_extract", "strip_extract", "init_keys",
                      "plane_gather", "mad_flag")),
    ("convolutions (cuDNN)", ("conv", "xmma", "gemm", "cudnn", "cutlass",
                              "wgrad", "dgrad", "fprop", "nhwc", "nchw")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_")),
    ("optimiser (foreach)", ("foreach", "multi_tensor")),
    ("copies", ("memcpy", "memset", "copy")),
)
OTHER_CLASS = "elementwise, reductions, other"


def classify(name):
    """The class of a device kernel by its name."""
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return OTHER_CLASS


def port_kernel(name, *keys):
    """True where ``name`` is one of the port's kernels whose name holds
    one of ``keys`` (``cluster_extract``: K1, K2, K4 at 128²;
    ``plane_gather``: K3; ``mad_flag``: K5)."""
    low = name.lower()
    return classify(name) == "port kernels" and any(k in low for k in keys)
