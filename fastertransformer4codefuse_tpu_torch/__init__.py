"""fastertransformer4codefuse_tpu_torch -- the PyTorch + CUDA port of
fastertransformer4codefuse_tpu, for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; every Pallas kernel of the JAX package on the
ported path is a hand-written CUDA kernel under ``csrc/``, built for sm_90a at
first use. Dispatch follows the tensor's device: a CUDA tensor launches the
kernel, a CPU tensor runs the kernel's plain PyTorch version. The JAX package
is the reference each module is tested against; this package never imports
it or jax.

Ported slices: CodeFuse-13B (GPT-NeoX, parallel residual) with weight-only
int8, or int4 weights (per-channel or group-wise scales), and an int8 KV
cache, served through ``GptNeoXEngine.generate``,
``api.handler.CodeFuseHandler.predict`` (static path, or a continuous-batching
pool with ``pool=``), ``engine.server.BatchingServer`` on dense or paged KV,
and ``api.http_server``. Encoders: BERT (float or int8 weights, K1) and
Longformer (local attention through K12, the banded sliding-window kernel),
served through ``engine.encoder_server.EncoderBatchingServer``. The decoder
families on the GPT-NeoX graph (LLaMA, Qwen2, StarCoder, GPT-J, GPT-2, OPT,
Mixtral) and the encoder-decoder, vision and audio families (T5 with
``engine.t5_engine.T5Engine`` and ``T5BatchingServer``, BART, Marian, ViT,
Swin, DeBERTa, XLNet, Conformer) through ``models.registry``. Constructors
build on the CUDA card unless given ``device="cpu"``.
"""

from .core.config import GptNeoXConfig, RuntimeConfig
from .engine.encoder_server import EncoderBatchingServer, T5BatchingServer
from .engine.engine import GenerationOutput, GptNeoXEngine
from .engine.t5_engine import T5Engine, T5Output
from .models.bert import BertConfig, BertEngine
from .models.longformer import LongformerConfig, LongformerEngine
from .models.params import QuantizedTensor, from_jax_params, init_params
from .models.t5 import T5Config

__version__ = "0.1.0"

__all__ = [
    "GptNeoXConfig",
    "RuntimeConfig",
    "GptNeoXEngine",
    "GenerationOutput",
    "QuantizedTensor",
    "init_params",
    "from_jax_params",
    "BertConfig",
    "BertEngine",
    "LongformerConfig",
    "LongformerEngine",
    "EncoderBatchingServer",
    "T5Config",
    "T5Engine",
    "T5Output",
    "T5BatchingServer",
]
