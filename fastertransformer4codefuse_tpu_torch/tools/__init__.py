"""The quality tools of the port (port of the JAX repo's ``tools/``
quality harness): ``train_proxy`` trains a byte-level GPT-NeoX on the
repository's own text, ``quality_eval`` measures NLL and greedy agreement,
``quality_table`` builds the quantization-quality table over the trained
proxy, and ``t5_quality_row`` does both for a T5 proxy. Run each with
``python -m fastertransformer4codefuse_tpu_torch.tools.<name>``: on the card
by default, on the CPU with ``--device cpu``."""
