"""s2vt_tpu_torch — the PyTorch/CUDA port of ``s2vt_tpu`` for NVIDIA Hopper.

A package beside ``s2vt_tpu`` that mirrors its layout; it imports ``torch``
and nothing of JAX or of ``s2vt_tpu``:

- ``ops``        — torch-gate-exact LSTM/GRU cells, torch-layout linear and
                   embedding, and the fused dual-LSTM S2VT forward as a
                   hand-written CUDA kernel (``csrc/``) with its plain twin.
- ``models``     — the S2VT encode-then-decode captioner.
- ``data``       — corpus preparation (MSVD CSV, MSR-VTT JSON), the
                   fixed-shape batch pipeline (the C++ reader pool of
                   ``native/s2vt_loader.cpp``, or numpy), and the GloVe
                   warm start.
- ``training``   — the model factory, the Trainer and its checkpoints
                   (``opt.json`` + ``params.npz``, written in the background
                   when asked).
- ``evaluation`` — greedy decoding over a dataset split.
- ``cocotools``  — the pycocotools COCO API and detection evaluator.
- ``utils``      — the weight bridge to and from the JAX parameter tree,
                   device selection, the g++ build of ``native/``, the RLE
                   mask ops, and profiling.

Float32 stays float32 on the card: TF32 is switched off for matmuls and
cuDNN when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
