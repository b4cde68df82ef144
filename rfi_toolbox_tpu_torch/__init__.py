"""rfi_toolbox_tpu_torch - the PyTorch/CUDA port of rfi_toolbox_tpu.

The JAX package ``rfi_toolbox_tpu`` is the reference; this package
mirrors its layout module for module, so that each function's
counterpart is found under the same path. It imports ``torch`` and
``numpy`` only, never ``jax`` or any module of ``rfi_toolbox_tpu``.

Public layouts are the JAX package's: waterfalls ``(M, C, T)``, images
NHWC ``(N, H, W, 3)``, flags ``(M, C, T)`` bool. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; with no card
they raise instead of falling back.

Subpackages (the slices ported so far: flagging, the training main
path, train -> export -> serve, training from files and raw patches, the
coherent 8-channel path, the SOLOLite instance path, the measurement-set
path, the command-line entry points with their YAML config, and runs over
several devices):
- utils: device resolution, the float32 precision switch, progress bars,
  the errors, and profiling (``trace``, ``annotate``, ``StepTimer``; the
  program's spans ``profiling.span`` and their recorder
  ``profiling.recording``: ``flag.*``, ``predict.*``, ``prep.*``,
  ``train.*`` and ``ms.*``, listed in ``utils/profiling.py``)
- config: the YAML config loader (``ConfigLoader``, ``TrainingConfig``,
  ``DataConfig``) and its validators
- cli: the commands ``generate_dataset``, ``normalize_data``,
  ``train_model`` and ``evaluate_model``, each run as ``python -m
  rfi_toolbox_tpu_torch.cli.<name>`` (on the card unless ``--device
  cpu``)
- visualization: ``visualize`` (Bokeh viewer or a matplotlib PNG,
  ``python -m rfi_toolbox_tpu_torch.visualization.visualize``)
- core, preprocessing, datasets, data_generation, scripts: the
  reference's import paths, as aliases of the modules above and below
- preprocess: the plain pipeline (the plain versions of the kernels),
  the static virtual-augmentation prep, ``Preprocessor`` and the
  raw-patch ``DevicePreprocessor``
- ops: hand-written CUDA kernels (csrc/) with their ctypes wrappers
- models: UNet (bfloat16 compute, Flax BatchNorm and initialisers),
  BatchNorm folding, Flax snapshot conversion; SOLOLite (dense instance
  segmentation), its loss, Matrix-NMS and decode
- synth: synthetic waterfall batches with exact RFI masks (or one mask
  per event), ``SyntheticDataGenerator``, which writes datasets to disk,
  and the coherent ``RFISimulator``
- data: ``ArrayDataset``, the batch-file writer ``BatchWriter``, the
  bounded-memory reader ``StreamingDataset``, ``load_batches`` and the
  sample-directory ``RFIMaskDataset``
- native: the threaded ``.npy`` reader (C++, built with g++ on first use)
- train: losses, the optax-equivalent optimiser, the train steps,
  ``Trainer`` (in memory or streamed from batch files),
  ``RawPatchTrainer``, ``CoherentTrainer`` and ``InstanceTrainer``
- serving: fixed-batch segmentation predictor (and its operation count,
  ``cost_analysis``)
- io: ``flag_waterfalls``, ``flag_waterfalls_coherent``, the
  Measurement Set reader ``MSLoader`` (casatools, optional, or the
  in-memory ``FakeMS``), ``inject_synthetic_data`` and
  ``flag_measurement_set`` (load -> flag on the card -> FLAG write-back)
- evaluation: segmentation metrics; instance matching and the held-out
  evaluation of ``InstanceTrainer``; MAD, FFI and calcquality statistics
- parallel: runs over several devices, one process each, joined by
  ``torch.distributed`` (``initialize_distributed``, ``make_mesh``,
  ``shard_batch``, tensor parallelism, ``preprocess_sharded``,
  ``sharded_global_stats``); the trainers, ``flag_waterfalls``,
  ``flag_measurement_set`` and ``train_model --mesh_shape`` take a mesh
"""

__version__ = "0.1.0"
