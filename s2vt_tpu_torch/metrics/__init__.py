"""Caption metrics (counterpart of ``s2vt_tpu.metrics``): BLEU-1..4, METEOR,
ROUGE-L, CIDEr / CIDEr-D and the PTB tokenizer, with no java and no nltk."""

from s2vt_tpu_torch.metrics.bleu import Bleu  # noqa: F401
from s2vt_tpu_torch.metrics.cider import Cider, CiderD  # noqa: F401
from s2vt_tpu_torch.metrics.meteor import Meteor  # noqa: F401
from s2vt_tpu_torch.metrics.rouge import Rouge  # noqa: F401
from s2vt_tpu_torch.metrics.tokenizer import PTBTokenizer  # noqa: F401
