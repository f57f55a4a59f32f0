"""The port's checkpoint modules against the JAX package's, on the CPU:
``ckpt/convert.py`` (the HF converter and the reference-format ``.bin``
writer), ``ckpt/quantize.py`` (``quant_and_save``, ``quantization_error``),
``ckpt/cutlass_interop.py``, ``ckpt/loader.py`` and the native reader shim,
with the cases of tests/test_ckpt.py and tests/test_cutlass_interop.py.

Tolerance: none. Written files are compared byte for byte, loaded
parameters value for value (bf16 by their bits), in every layout the loader
reads: float, int8 ``.q.bin``, int4 ``.q4.bin`` per-channel and group-wise,
quantize-on-load, the CUTLASS layout, tp 1 and 2."""
import glob
import os
import re

import numpy as np
import pytest
import torch
import transformers

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu.ckpt import convert as jconvert
from fastertransformer4codefuse_tpu.ckpt import cutlass_interop as jcut
from fastertransformer4codefuse_tpu.ckpt import loader as jloader
from fastertransformer4codefuse_tpu.ckpt import quantize as jquant
from fastertransformer4codefuse_tpu.api import wordlist_csv as jwl
from fastertransformer4codefuse_tpu_torch import native
from fastertransformer4codefuse_tpu_torch.api import wordlist_csv
from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
from fastertransformer4codefuse_tpu_torch.ckpt import convert, cutlass_interop, loader, quantize
from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor

torch.set_num_threads(2)


def make_hf(seed=0, parallel=True, hidden=64, inter=256):
    torch.manual_seed(seed)
    cfg = transformers.GPTNeoXConfig(
        vocab_size=96, hidden_size=hidden, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=inter, rotary_pct=0.25,
        max_position_embeddings=128, use_parallel_residual=parallel,
        bos_token_id=0, eos_token_id=95, hidden_act="gelu",
    )
    return transformers.GPTNeoXForCausalLM(cfg).eval()


def _bits(a):
    """numpy bits of a torch tensor or a JAX array (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_params_equal(tp, jp):
    """The port's parameter dict equals the JAX pytree leaf for leaf, bit for
    bit, dtypes included."""
    if isinstance(jp, dict):
        assert set(tp) == set(jp)
        for k in jp:
            assert_params_equal(tp[k], jp[k])
        return
    if hasattr(jp, "q") and hasattr(jp, "scale"):
        assert isinstance(tp, QuantizedTensor)
        assert (tp.bits, tp.group_size, tp.k_axis) == (jp.bits, jp.group_size, jp.k_axis)
        assert_params_equal(tp.q, jp.q)
        assert_params_equal(tp.scale, jp.scale)
        return
    a, b = _bits(tp), _bits(jp)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _dir_bytes(path):
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(path, "*")))}


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("wdt", ["fp32", "fp16"])
def test_convert_hf_to_bin_writes_the_jax_bytes(tmp_path, tp, wdt):
    hf = make_hf()
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    cfg = convert.convert_hf_to_bin(hf, a, infer_tp=tp, weight_data_type=wdt)
    jcfg = jconvert.convert_hf_to_bin(hf, b, infer_tp=tp, weight_data_type=wdt)
    assert cfg.__dict__ == jcfg.__dict__
    da, db = _dir_bytes(a), _dir_bytes(b)
    assert sorted(da) == sorted(db) and da == db


@pytest.mark.parametrize("parallel", [True, False])
def test_params_from_hf_and_the_reorders_match_jax(parallel):
    hf = make_hf(parallel=parallel)
    cfg, jcfg = convert.config_from_hf(hf.config), jconvert.config_from_hf(hf.config)
    assert cfg.__dict__ == jcfg.__dict__ and cfg.activation == "gelu"
    tp = convert.params_from_hf_state_dict(cfg, hf.state_dict(), dtype="bf16", device="cpu")
    jp = jconvert.params_from_hf_state_dict(jcfg, hf.state_dict(), dtype="bf16")
    assert_params_equal(tp, jp)
    rng = np.random.default_rng(0)
    w, bias = rng.standard_normal((192, 64)), rng.standard_normal(192)
    np.testing.assert_array_equal(convert._reorder_qkv_weight(w, 4),
                                  jconvert._reorder_qkv_weight(w, 4))
    np.testing.assert_array_equal(convert._reorder_qkv_bias(bias, 4),
                                  jconvert._reorder_qkv_bias(bias, 4))
    sd = {f"model.layers.0.self_attn.{n}_proj.{k}": rng.standard_normal(
        (8, 16) if k == "weight" else 8) for n in "qkv" for k in ("weight", "bias")}
    np.testing.assert_array_equal(convert.fused_qkv_concat(sd.get, 0),
                                  jconvert.fused_qkv_concat(sd.get, 0))
    np.testing.assert_array_equal(convert.fused_qkv_bias_concat(sd.get, 0),
                                  jconvert.fused_qkv_bias_concat(sd.get, 0))


@pytest.mark.parametrize("bits,G", [(8, 0), (4, 0), (4, 16)])
@pytest.mark.parametrize("wdt", ["fp32", "fp16"])
def test_quant_and_save_writes_the_jax_bytes(tmp_path, bits, G, wdt):
    hf = make_hf()
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    convert.convert_hf_to_bin(hf, a, weight_data_type=wdt)
    jconvert.convert_hf_to_bin(hf, b, weight_data_type=wdt)
    quantize.quant_and_save(a, weight_bits=bits, group_size=G)
    jquant.quant_and_save(b, weight_bits=bits, group_size=G)
    da, db = _dir_bytes(a), _dir_bytes(b)
    assert sorted(da) == sorted(db) and da == db
    assert any(n.endswith(".q.bin" if bits == 8 else ".q4.bin") for n in da)


def test_quant_and_save_reads_only_the_float_kernels(tmp_path):
    """int4 then int8 payloads in one directory: the int8 pass quantizes the
    float kernels, not the earlier .q4.bin files."""
    hf = make_hf()
    a, b = str(tmp_path / "both"), str(tmp_path / "int8")
    convert.convert_hf_to_bin(hf, a)
    convert.convert_hf_to_bin(hf, b)
    quantize.quant_and_save(a, weight_bits=4, group_size=16)
    quantize.quant_and_save(a, weight_bits=8)
    quantize.quant_and_save(b, weight_bits=8)
    da, db = _dir_bytes(a), _dir_bytes(b)
    assert {n: v for n, v in da.items() if n in db} == db


def test_quant_and_save_over_int4_payloads_is_the_jax_tool_without_its_junk(tmp_path):
    """int4 g16 then int8 over one directory, by both tools. The JAX tool
    also takes each earlier ``.q4.bin`` / ``.s4g16.bin`` for a float kernel
    and writes int8 quantizations of those bytes (``*.q4.q.bin``,
    ``*.s4g16.s.bin``, ...) that no loader reads; the port reads only the
    float rank files. Every other file is byte for byte the JAX tool's."""
    hf = make_hf()
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    convert.convert_hf_to_bin(hf, a)
    jconvert.convert_hf_to_bin(hf, b)
    for bits, G in ((4, 16), (8, 0)):
        quantize.quant_and_save(a, weight_bits=bits, group_size=G)
        jquant.quant_and_save(b, weight_bits=bits, group_size=G)
    da, db = _dir_bytes(a), _dir_bytes(b)
    junk = {n for n in db if re.search(r"\.(q4|s4g16)\.(q|s)\.bin$", n)}
    assert junk and not junk & set(da)
    assert da == {n: v for n, v in db.items() if n not in junk}


def test_quantization_error_matches_jax():
    w = np.random.default_rng(3).standard_normal((64, 32)).astype(np.float32)
    assert quantize.quantization_error(w) == jquant.quantization_error(jnp.asarray(w))
    assert quantize.quantization_error(w) <= float(np.abs(w).max(0).max() / 127 / 2) + 1e-7


def _make_dir(tmp_path, tp, wdt="fp32", q=(), hidden=64, inter=256, name="ckpt"):
    """A reference-format directory from a tiny HF model, plus the payloads
    ``q`` [(bits, G), ...] written by quant_and_save."""
    hf = make_hf(hidden=hidden, inter=inter)
    path = str(tmp_path / name)
    convert.convert_hf_to_bin(hf, path, infer_tp=tp, weight_data_type=wdt)
    for bits, G in q:
        quantize.quant_and_save(path, weight_bits=bits, group_size=G)
    return path


LOADS = [
    # (tp, payloads on disk, load kwargs)
    (1, (), dict()),
    (2, (), dict()),
    (1, (), dict(int8_mode=1)),  # quantize on load
    (1, ((8, 0),), dict(int8_mode=1)),
    (2, ((8, 0),), dict(int8_mode=1)),  # row-split ranks requantized whole
    (1, ((4, 0),), dict(int8_mode=1, weight_bits=4)),
    (1, ((4, 16),), dict(int8_mode=1, weight_bits=4, group_size=16)),
    (2, (), dict(int8_mode=1, weight_bits=4, group_size=16)),  # tp 2 int4: on load
    (1, ((8, 0),), dict(int8_mode=2)),  # the quantize_embeddings alias
    (1, ((4, 16),), dict(int8_mode=1, weight_bits=4, group_size=16, quantize_embeddings=True)),
]


@pytest.mark.parametrize("tp,payloads,kw", LOADS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_loader_equals_the_jax_loader(tmp_path, tp, payloads, kw, dtype):
    path = _make_dir(tmp_path, tp, q=payloads)
    assert loader.detect_tp_size(path) == jloader.detect_tp_size(path) == tp
    cfg, tp_params = loader.load_bin_checkpoint(path, dtype=dtype, device="cpu", **kw)
    jcfg, jp = jloader.load_bin_checkpoint(path, dtype=dtype, **kw)
    assert cfg.__dict__ == jcfg.__dict__
    assert_params_equal(tp_params, jp)


def test_loader_int4_group_scales_from_fp16_bit_for_bit(tmp_path):
    """fp16 on disk, bf16 in memory: the JAX loader's round trip is exact
    only for stored values in fp16's normal range. One group of tiny weights
    gives a scale below 6.1e-5 (an fp16 subnormal); the port's loaded scales
    equal the JAX loader's bit for bit, that one included."""
    G = 16
    hf = make_hf()
    with torch.no_grad():
        hf.gpt_neox.layers[0].mlp.dense_h_to_4h.weight[:5, :G] *= 1e-3
    path = str(tmp_path / "fp16")
    convert.convert_hf_to_bin(hf, path, weight_data_type="fp16")
    quantize.quant_and_save(path, weight_bits=4, group_size=G)
    kw = dict(dtype="bf16", int8_mode=1, weight_bits=4, group_size=G)
    _, tp_params = loader.load_bin_checkpoint(path, device="cpu", **kw)
    _, jp = jloader.load_bin_checkpoint(path, **kw)
    assert_params_equal(tp_params, jp)
    up = tp_params["layers"]["up_w"].scale.float()
    assert 0 < float(up[0, 0, :5].max()) < 6.1e-5  # the subnormal case is present


@pytest.mark.parametrize("tp", [1, 2])
def test_loader_undoes_the_cutlass_layout_as_jax_does(tmp_path, tp):
    """.q.bin written as the reference writes it (per rank file: quantize,
    then the CUTLASS preprocessing), loaded with q_layout="cutlass"."""
    path = _make_dir(tmp_path, tp, hidden=128, inter=512)
    H = 128
    for p in sorted(glob.glob(os.path.join(path, "model.layers.*.weight.*.bin"))):
        name = os.path.basename(p)
        if "layernorm" in name:
            continue
        flat = np.fromfile(p, dtype=np.float32)
        k_dim = H if ("query_key_value" in name or "h_to_4h" in name) else flat.size // H
        qt = quantize.quantize_array(flat.reshape(k_dim, -1), k_axis=-2)
        cutlass_interop.preprocess_weights_for_mixed_gemm(qt.q.numpy(), bits=8).tofile(
            p[:-4] + ".q.bin")
        qt.scale.numpy().astype(np.float32).tofile(p[:-4] + ".s.bin")
    kw = dict(dtype="fp32", int8_mode=1, q_layout="cutlass")
    _, tp_params = loader.load_bin_checkpoint(path, device="cpu", **kw)
    _, jp = jloader.load_bin_checkpoint(path, **kw)
    assert_params_equal(tp_params, jp)
    _, fp = loader.load_bin_checkpoint(path, dtype="fp32", device="cpu")
    up = tp_params["layers"]["up_w"]
    err = (up.dequantize() - fp["layers"]["up_w"]).abs()
    assert bool((err <= up.scale[:, None, :] / 2 + 1e-6).all())


def test_ft_qkv_order_commutes_with_packing_and_group_scales():
    """_ft_qkv_to_engine on the packed int4 rows and on the [K/G, 3, ...]
    scales equals packing (and grouping) the reordered float kernel."""
    nH, dh, H, G = 4, 8, 32, 16
    rng = np.random.default_rng(1)
    w = rng.standard_normal((H, 3, nH * dh)).astype(np.float32)
    qt = quantize.quantize_array(w.reshape(H, -1), bits=4, group_size=G)
    q = loader._ft_qkv_to_engine(qt.q.numpy().reshape(H // 2, 3, -1), nH)
    s = loader._ft_qkv_to_engine(qt.scale.float().numpy().reshape(H // G, 3, -1), nH)
    ref = quantize.quantize_array(loader._ft_qkv_to_engine(w, nH), bits=4, group_size=G)
    np.testing.assert_array_equal(q, ref.q.numpy())
    np.testing.assert_array_equal(s, ref.scale.float().numpy())
    np.testing.assert_array_equal(loader._ft_qkv_to_engine(w, nH), jloader._ft_qkv_to_engine(w, nH))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N", [(64, 32), (128, 48), (256, 128)])
def test_cutlass_interop_matches_jax(bits, K, N):
    rng = np.random.default_rng(K + N + bits)
    lo, hi = (-128, 128) if bits == 8 else (-8, 8)
    w = rng.integers(lo, hi, (K, N)).astype(np.int8)
    raw = cutlass_interop.preprocess_weights_for_mixed_gemm(w, bits)
    np.testing.assert_array_equal(raw, jcut.preprocess_weights_for_mixed_gemm(w, bits))
    np.testing.assert_array_equal(cutlass_interop.unpreprocess_weights(raw, K, N, bits), w)
    packed = cutlass_interop.pack_int4(rng.integers(-8, 8, (4, 8)).astype(np.int8))
    np.testing.assert_array_equal(cutlass_interop.unpack_int4(packed), jcut.unpack_int4(packed))


def test_cutlass_reference_vectors():
    """The reference's unit-test vectors (th_weight_quant_ops_unit_tests.py)
    for the int4 unpack, the register shuffles and the row maps."""
    packed = np.array([0x21, 0xF8], np.uint8).view(np.int8)
    np.testing.assert_array_equal(cutlass_interop.unpack_int4(packed), [1, 2, -8, -1])
    flat = np.arange(8, dtype=np.int8) - 4
    out8 = cutlass_interop.add_bias_and_interleave(flat, 8)
    np.testing.assert_array_equal(out8, np.array([-4, -2, -3, -1, 0, 2, 1, 3]) + 128)
    out4 = cutlass_interop.add_bias_and_interleave(flat, 4)
    np.testing.assert_array_equal(out4, np.array([-4, -2, 0, 2, -3, -1, 1, 3]) + 8)
    for bits, tile in ((8, 16), (4, 32)):
        rows = np.arange(2 * tile)[:, None].repeat(4, 1)
        got = cutlass_interop.permute_b_rows(rows, bits)[:tile, 0]
        np.testing.assert_array_equal(got, cutlass_interop.PERM16 if bits == 8
                                      else cutlass_interop.PERM32)


def test_native_reader_and_trie(tmp_path):
    """The port's ctypes shim over native/: the bulk reader, file sizes and
    the trie (built by native/build.sh on first use)."""
    if not native.available():
        pytest.skip("native/build.sh could not build the library here")
    paths = []
    for i, n in enumerate((0, 7, 4096 + 3)):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes(range(256)) * (n // 256) + bytes(range(n % 256)))
        paths.append(str(p))
    bufs = [np.empty(os.path.getsize(p), np.uint8) for p in paths]
    native.read_files(paths, bufs, threads=2)
    for p, b in zip(paths, bufs):
        assert b.tobytes() == open(p, "rb").read() and native.file_size(p) == b.nbytes
    vocab = {"vo": 0, "void": 1, "voice": 2, "x": 3}
    nt, pt = native.NativeTrie(vocab), VocabTrie(vocab)
    for key in ("vo", "voi", "void", "x", "z"):
        a, b = [], []
        assert nt.printAutoSuggestions(key, a) == pt.printAutoSuggestions(key, b)
        assert sorted(a) == sorted(b)


def test_loader_reads_through_python_when_the_library_is_missing(tmp_path, monkeypatch):
    path = _make_dir(tmp_path, 1, q=((8, 0),))
    _, with_native = loader.load_bin_checkpoint(path, int8_mode=1, device="cpu")
    monkeypatch.setattr(native, "_load", lambda: None)
    _, fallback = loader.load_bin_checkpoint(path, int8_mode=1, device="cpu")
    assert loader.last_read["reader"] == "python thread pool"
    assert loader.last_read["bytes"] == sum(os.path.getsize(p) for p in
                                            glob.glob(os.path.join(path, "*.bin")))
    for a, b in zip(jax.tree_util.tree_leaves(_flat(fallback)),
                    jax.tree_util.tree_leaves(_flat(with_native))):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _flat(params):
    """Nested dict with QuantizedTensors -> nested dict of tensors."""
    if isinstance(params, dict):
        return {k: _flat(v) for k, v in params.items()}
    if isinstance(params, QuantizedTensor):
        return {"q": params.q, "scale": params.scale}
    return params


def test_word_list_csv_matches_jax(tmp_path):
    p = tmp_path / "words.csv"
    p.write_text("5,6,7\n2,3\n\n9\n1\n")
    np.testing.assert_array_equal(wordlist_csv.read_word_list_csv(str(p)),
                                  jwl.read_word_list_csv(str(p)))
    s = tmp_path / "start_ids.csv"
    s.write_text("1,2,3,\n4,5\n")
    assert wordlist_csv.read_start_ids_csv(str(s)) == jwl.read_start_ids_csv(str(s))
    p.write_text("5,6,7\n")
    with pytest.raises(ValueError):
        wordlist_csv.read_word_list_csv(str(p))
