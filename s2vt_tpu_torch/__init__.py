"""s2vt_tpu_torch — the PyTorch/CUDA port of ``s2vt_tpu`` for NVIDIA Hopper.

A package beside ``s2vt_tpu`` that mirrors its layout; it imports ``torch``
and nothing of JAX or of ``s2vt_tpu``:

- ``ops``        — torch-gate-exact LSTM/GRU cells, torch-layout linear and
                   embedding, and the fused dual-LSTM S2VT forward as a
                   hand-written CUDA kernel (``csrc/``) with its plain twin.
- ``models``     — the S2VT encode-then-decode captioner.
- ``data``       — the captions.json corpus reader and the fixed-shape batch
                   pipeline (numpy backend).
- ``training``   — the model factory and the checkpoint loader
                   (``opt.json`` + ``params.npz``).
- ``evaluation`` — greedy decoding over a dataset split.
- ``utils``      — the weight bridge to and from the JAX parameter tree, and
                   device selection.

Float32 stays float32 on the card: TF32 is switched off for matmuls and
cuDNN when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
