"""The port stands alone: every module of s2vt_tpu_torch imports with JAX and
nltk blocked, and none of them loads the JAX package s2vt_tpu."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
sys.modules['jax'] = None
sys.modules['nltk'] = None
import s2vt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(s2vt_tpu_torch.__path__, 's2vt_tpu_torch.')]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == 's2vt_tpu' or k.startswith('s2vt_tpu.'))
jax_loaded = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax')
                    and sys.modules[k] is not None)
print(",".join(names), leaked, jax_loaded)
"""

# Modules that must exist and import without JAX (the slices so far).
REQUIRED = {
    "s2vt_tpu_torch.cli.train", "s2vt_tpu_torch.data.dataset",
    "s2vt_tpu_torch.evaluation.decode", "s2vt_tpu_torch.models.attention",
    "s2vt_tpu_torch.models.beam", "s2vt_tpu_torch.models.s2vt",
    "s2vt_tpu_torch.ops.fused_att_decode", "s2vt_tpu_torch.ops.fused_gru",
    "s2vt_tpu_torch.ops.fused_rnn",
    "s2vt_tpu_torch.ops.fused_s2vt", "s2vt_tpu_torch.ops.losses",
    "s2vt_tpu_torch.training.callbacks", "s2vt_tpu_torch.training.checkpoint",
    "s2vt_tpu_torch.training.loop",
    "s2vt_tpu_torch.ops.fused_decode", "s2vt_tpu_torch.ops.fused_conv",
    "s2vt_tpu_torch.serving", "s2vt_tpu_torch.serving.export",
    "s2vt_tpu_torch.cli.export_serving", "s2vt_tpu_torch.cli.extract",
    "s2vt_tpu_torch.cli.caption", "s2vt_tpu_torch.extract",
    "s2vt_tpu_torch.extract.video", "s2vt_tpu_torch.extract.preprocess",
    "s2vt_tpu_torch.extract.backbones", "s2vt_tpu_torch.extract.torch_weights",
    "s2vt_tpu_torch.extract.pipeline", "s2vt_tpu_torch.utils.weights",
    "s2vt_tpu_torch.data.learnable", "s2vt_tpu_torch.utils.native_build",
    "s2vt_tpu_torch.metrics", "s2vt_tpu_torch.metrics.porter",
    "s2vt_tpu_torch.metrics.tokenizer", "s2vt_tpu_torch.metrics.bleu",
    "s2vt_tpu_torch.metrics.rouge", "s2vt_tpu_torch.metrics.cider",
    "s2vt_tpu_torch.metrics.meteor", "s2vt_tpu_torch.evaluation",
    "s2vt_tpu_torch.evaluation.scorer", "s2vt_tpu_torch.evaluation.coco_eval",
    "s2vt_tpu_torch.cli.eval", "s2vt_tpu_torch.tools.learning_gate",
}


def test_port_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names, leaked, jax_loaded = proc.stdout.strip().split(" ", 2)
    assert REQUIRED <= set(names.split(",")), REQUIRED - set(names.split(","))
    assert (leaked, jax_loaded) == ("[]", "[]"), proc.stdout
