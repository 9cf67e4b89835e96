"""The frozen text towers in the port against the JAX package on the CPU:
the CLIP text transformer (quick_gelu and gelu, the legacy and the explicit
EOS rule, the penultimate tap, padding masks, with and without the
projection), the T5 encoder (relu and gated-gelu, the padding mask, block
0's shared relative-position bias, the bucket function over -300..300), the
HF-state-dict importers on synthetic HF-layout state dicts (the port's
import equals JAX's through the weight bridge bit for bit), the embedders'
real paths with injected towers and tokenizers (the per-prompt cache,
`text_attention_mask`, `include_temporal`), `FrozenCLIPEmbedder`, SD3's
three-tower stack in both padding directions and through its preprocessor,
CLAP with a stand-in model, the loaders finding nothing without
`transformers`, and the three published towers' parameter shapes.

Towers are tiny (2 layers, widths 16-48); weights are numpy draws in HF's
layout, loaded on each side by its own importer. fp32 forwards agree to
2e-5 absolute."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_port_common import no_transformers, one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-5
VOCAB = 100
EOS = VOCAB - 1
N = 16
PROMPTS = ["3", "seven", "a handwritten digit three", "", "zéro and one", "3"]


def clip_kwargs(**kw):
    base = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=N, hidden_act="quick_gelu",
                eos_token_id=EOS, projection_dim=None)
    base.update(kw)
    return base


def t5_kwargs(**kw):
    base = dict(vocab_size=VOCAB, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
                relative_attention_num_buckets=32, relative_attention_max_distance=128,
                feed_forward_proj="gated-gelu")
    base.update(kw)
    return base


def hf_clip_sd(kw, seed: int, prefix: bool = True):
    """A synthetic HF CLIPTextModel(WithProjection) state dict."""
    rng = np.random.default_rng(seed)
    d, f = kw["hidden_size"], kw["intermediate_size"]
    pfx = "text_model." if prefix else ""
    r = lambda *s, scale=0.1: (scale * rng.standard_normal(s)).astype(np.float32)
    sd = {f"{pfx}embeddings.token_embedding.weight": r(kw["vocab_size"], d, scale=0.5),
          f"{pfx}embeddings.position_embedding.weight": r(kw["max_position_embeddings"], d),
          f"{pfx}final_layer_norm.weight": 1 + r(d), f"{pfx}final_layer_norm.bias": r(d)}
    for i in range(kw["num_hidden_layers"]):
        base = f"{pfx}encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{base}.self_attn.{proj}.weight"] = r(d, d, scale=d ** -0.5)
            sd[f"{base}.self_attn.{proj}.bias"] = r(d)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{base}.{ln}.weight"], sd[f"{base}.{ln}.bias"] = 1 + r(d), r(d)
        sd[f"{base}.mlp.fc1.weight"], sd[f"{base}.mlp.fc1.bias"] = r(f, d, scale=d ** -0.5), r(f)
        sd[f"{base}.mlp.fc2.weight"], sd[f"{base}.mlp.fc2.bias"] = r(d, f, scale=f ** -0.5), r(d)
    if kw["projection_dim"] is not None:
        sd["text_projection.weight"] = r(kw["projection_dim"], d, scale=d ** -0.5)
    return sd


def hf_t5_sd(kw, seed: int, shared: bool = True):
    """A synthetic HF T5EncoderModel state dict (its table as `shared.weight`
    or as `encoder.embed_tokens.weight`)."""
    rng = np.random.default_rng(seed)
    d, inner, f = kw["d_model"], kw["num_heads"] * kw["d_kv"], kw["d_ff"]
    r = lambda *s, scale=0.1: (scale * rng.standard_normal(s)).astype(np.float32)
    sd = {("shared.weight" if shared else "encoder.embed_tokens.weight"): r(kw["vocab_size"], d,
                                                                             scale=1.0),
          "encoder.final_layer_norm.weight": 1 + r(d)}
    for i in range(kw["num_layers"]):
        base = f"encoder.block.{i}"
        for p in ("q", "k", "v"):
            sd[f"{base}.layer.0.SelfAttention.{p}.weight"] = r(inner, d, scale=d ** -0.5)
        sd[f"{base}.layer.0.SelfAttention.o.weight"] = r(d, inner, scale=inner ** -0.5)
        if i == 0:
            sd[f"{base}.layer.0.SelfAttention.relative_attention_bias.weight"] = r(
                kw["relative_attention_num_buckets"], kw["num_heads"], scale=0.5)
        sd[f"{base}.layer.0.layer_norm.weight"] = 1 + r(d)
        sd[f"{base}.layer.1.layer_norm.weight"] = 1 + r(d)
        wis = ("wi_0", "wi_1") if kw["feed_forward_proj"].startswith("gated") else ("wi",)
        for w in wis:
            sd[f"{base}.layer.1.DenseReluDense.{w}.weight"] = r(f, d, scale=d ** -0.5)
        sd[f"{base}.layer.1.DenseReluDense.wo.weight"] = r(d, f, scale=f ** -0.5)
    return sd


def zeros_of(module, *args):
    """The flax module's parameter tree of zeros (shapes from
    jax.eval_shape of init: no real init), for the JAX importers."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def clip_pair(kw, seed: int = 0, prefix: bool = True):
    """(JAX module, its imported params, port tower) on one synthetic state
    dict."""
    from xdiffusion_tpu.layers import text_encoders as jte

    from xdiffusion_tpu_torch.layers import text_encoders as pte

    sd = hf_clip_sd(kw, seed, prefix)
    jmod = jte.CLIPTextTransformer(jte.CLIPTextConfig(**kw))
    jparams = jte.import_hf_clip_text(zeros_of(jmod, jnp.zeros((1, 4), jnp.int32)), sd)
    tower = pte.import_hf_clip_text(pte.CLIPTextTransformer(pte.CLIPTextConfig(**kw)),
                                    {k: torch.from_numpy(v) for k, v in sd.items()})
    return jmod, jparams, tower


def t5_pair(kw, seed: int = 0, shared: bool = True):
    from xdiffusion_tpu.layers import text_encoders as jte

    from xdiffusion_tpu_torch.layers import text_encoders as pte

    sd = hf_t5_sd(kw, seed, shared)
    jmod = jte.T5Encoder(jte.T5Config(**kw))
    jparams = jte.import_hf_t5_encoder(zeros_of(jmod, jnp.zeros((1, 4), jnp.int32)), sd)
    tower = pte.import_hf_t5_encoder(pte.T5Encoder(pte.T5Config(**kw)), sd)
    return jmod, jparams, tower


def token_batch(seed: int, n: int = N, lengths=(3, 9, 16, 1)):
    """(ids, mask): BOS-free random ids in [3, EOS), EOS at each length's
    end and right padding by the EOS id (CLIP-L's convention), mask 1 up to
    the EOS."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, EOS, size=(len(lengths), n)).astype(np.int32)
    mask = np.zeros_like(ids)
    for i, length in enumerate(lengths):
        ids[i, length - 1:] = EOS
        mask[i, :length] = 1
    return ids, mask


def run_clip(jmod, jparams, tower, ids, mask, penultimate):
    apply = jax.jit(jmod.apply, static_argnames=("penultimate",))
    jm = None if mask is None else jnp.asarray(mask)
    want = [np.asarray(t) for t in apply(jparams, jnp.asarray(ids), jm, penultimate=penultimate)]
    with torch.no_grad():
        pm = None if mask is None else torch.from_numpy(mask)
        got = [t.numpy() for t in tower(torch.from_numpy(ids), pm, penultimate=penultimate)]
    return got, want


@pytest.mark.parametrize("act,eos,projection,penultimate,masked", [
    ("quick_gelu", EOS, None, False, True),
    ("quick_gelu", EOS, 24, True, False),
    ("gelu", 2, 24, False, True),
    ("gelu", 2, None, True, True),
    ("gelu_new", EOS, None, False, False),
])
def test_clip_tower_matches_jax(act, eos, projection, penultimate, masked):
    """Hidden states (final-LN or penultimate) and pooled (projected) vector
    at 2e-5; the EOS the pool takes is the first EOS (explicit id) or the
    largest id (legacy `eos_token_id == 2`), so rows padded by the EOS id
    pool at their first EOS."""
    kw = clip_kwargs(hidden_act=act, eos_token_id=eos, projection_dim=projection)
    jmod, jparams, tower = clip_pair(kw, seed=1)
    ids, mask = token_batch(2)
    got, want = run_clip(jmod, jparams, tower, ids, mask if masked else None, penultimate)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    assert got[1].shape == (4, projection or 32)


def test_clip_padding_mask_and_pooling_position():
    """With right padding by the EOS id no query row is fully masked; the
    mask changes nothing before the first EOS (causal), and the pooled row
    is the final hidden state there."""
    jmod, jparams, tower = clip_pair(clip_kwargs(), seed=3)
    ids, mask = token_batch(4)
    (h_masked, pooled), _ = run_clip(jmod, jparams, tower, ids, mask, False)
    (h_plain, _), _ = run_clip(jmod, jparams, tower, ids, None, False)
    assert np.isfinite(h_masked).all()
    for i, length in enumerate((3, 9, 16, 1)):
        np.testing.assert_allclose(h_masked[i, :length], h_plain[i, :length], atol=1e-6)
        np.testing.assert_array_equal(pooled[i], h_masked[i, length - 1])


def test_tanh_gelu_is_jaxs_and_differs_from_hf_exact_gelu():
    """The JAX tower's "gelu" is `jax.nn.gelu`, the tanh approximation; HF's
    "gelu" (CLIP-bigG's) is the exact erf form. The port follows JAX: its
    `_act("gelu")` equals jax.nn.gelu and differs from the erf form by more
    than 1e-4 (ROADMAP queue 3)."""
    from xdiffusion_tpu.layers.text_encoders import _act as jax_act

    from xdiffusion_tpu_torch.layers.text_encoders import _act

    x = np.linspace(-4, 4, 801).astype(np.float32)
    port = _act("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, np.asarray(jax_act("gelu")(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(port, _act("gelu_new")(torch.from_numpy(x)).numpy())
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(port - exact).max() > 1e-4


@pytest.mark.parametrize("ff,masked", [("gated-gelu", True), ("relu", False)])
def test_t5_encoder_matches_jax(ff, masked):
    """The last hidden state at 2e-5 over 24 tokens (relative distances past
    max_exact, the log buckets), with the padding mask; only block 0 holds
    the bias table, and the later blocks reuse its bias."""
    from xdiffusion_tpu_torch.weights import flax_paths

    jmod, jparams, tower = t5_pair(t5_kwargs(feed_forward_proj=ff), seed=5)
    ids, mask = token_batch(6, n=24, lengths=(24, 10, 1))
    apply = jax.jit(jmod.apply)
    want = np.asarray(apply(jparams, jnp.asarray(ids), jnp.asarray(mask) if masked else None))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids), torch.from_numpy(mask) if masked else None).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    tables = [p for p in flax_paths(tower).values() if "relative_attention_bias" in p]
    assert tables == ["block_0/attn/relative_attention_bias/embedding"]


def test_t5_bucket_function_is_exact_over_minus_300_to_300():
    from xdiffusion_tpu.layers.text_encoders import _t5_relative_position_bucket as jax_bucket

    from xdiffusion_tpu_torch.layers.text_encoders import _t5_relative_position_bucket

    rel = np.arange(-300, 301, dtype=np.int64)
    for buckets, distance in ((32, 128), (32, 20), (8, 64)):
        got = _t5_relative_position_bucket(rel, buckets, distance)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, jax_bucket(rel, buckets, distance))
    grid = np.arange(40)[None, :] - np.arange(40)[:, None]
    np.testing.assert_array_equal(_t5_relative_position_bucket(grid, 32, 128),
                                  jax_bucket(grid, 32, 128))


@pytest.mark.parametrize("kind,variant", [("clip", True), ("clip", False), ("t5", True),
                                          ("t5", False)])
def test_importers_equal_jax_import_through_the_bridge(kind, variant):
    """CLIP with and without the `text_model.` prefix (and a projection);
    T5 with `shared.weight` and with `encoder.embed_tokens.weight`: the
    port's import equals JAX's flax tree through the weight bridge, bit for
    bit."""
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    if kind == "clip":
        _, jparams, tower = clip_pair(clip_kwargs(projection_dim=24), seed=7, prefix=variant)
    else:
        _, jparams, tower = t5_pair(t5_kwargs(), seed=7, shared=variant)
    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jparams["params"]).items()}
    want = flax_to_state_dict(flat, tower)
    got = tower.state_dict()
    assert set(got) == set(want)
    for name in got:
        assert torch.equal(got[name], want[name]), name


def test_importers_raise_on_a_missing_key_or_a_wrong_shape():
    from xdiffusion_tpu_torch.layers import text_encoders as pte

    kw = clip_kwargs()
    sd = hf_clip_sd(kw, 0)
    del sd["text_model.encoder.layers.1.mlp.fc2.bias"]
    with pytest.raises(KeyError):
        pte.import_hf_clip_text(pte.CLIPTextTransformer(pte.CLIPTextConfig(**kw)), sd)
    sd = hf_t5_sd(t5_kwargs(), 0)
    sd["encoder.final_layer_norm.weight"] = np.ones(7, np.float32)
    with pytest.raises(ValueError):
        pte.import_hf_t5_encoder(pte.T5Encoder(pte.T5Config(**t5_kwargs())), sd)


class StandInTokenizer:
    """An HF tokenizer's call surface over bytes: [BOS] + one id per UTF-8
    byte in [3, EOS) + [EOS], truncated to max_length with the EOS kept
    last, padded to max_length by `pad_id`; returns int64 `input_ids` and
    `attention_mask` (1 up to the EOS) as numpy or torch tensors."""

    def __init__(self, bos: int = 1, pad_id: int = EOS):
        self.bos, self.pad_id = bos, pad_id

    def __call__(self, texts, max_length=N, padding="max_length", truncation=True,
                 return_tensors="np"):
        rows = []
        for text in texts:
            body = [3 + b % (EOS - 3) for b in text.encode("utf-8")][:max_length - 2]
            rows.append([self.bos] + body + [EOS])
        width = max_length if padding == "max_length" else max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_id, np.int64)
        mask = np.zeros_like(ids)
        for i, r in enumerate(rows):
            ids[i, :len(r)], mask[i, :len(r)] = r, 1
        if return_tensors == "pt":
            return {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)}
        return {"input_ids": ids, "attention_mask": mask}


def test_clip_text_embedder_real_path_matches_jax(monkeypatch):
    """Injected (config, tower, tokenizer) on both sides under one version:
    pooled embeddings at 2e-5, each prompt encoded once (the per-prompt
    cache: a second call runs no tower)."""
    from xdiffusion_tpu.layers import embedding as jemb

    from xdiffusion_tpu_torch.layers import embedding as pemb

    kw = clip_kwargs()
    jmod, jparams, tower = clip_pair(kw, seed=9)
    version, tok = "stand-in/clip", StandInTokenizer()
    monkeypatch.setitem(jemb._FrozenEncoderCache._loaded, ("clip", version),
                        (jmod.config, jparams, tok))
    monkeypatch.setitem(pemb._FrozenEncoderCache._loaded, ("clip", version),
                        (tower.config, tower, tok))
    args = dict(max_length=N, version=version, embedding_dim=32)
    want = np.asarray(jemb.CLIPTextEmbedder(**args)({"text_prompts": PROMPTS})[
        "clip_text_embeddings"])
    embedder = pemb.CLIPTextEmbedder(**args)
    got = embedder({"text_prompts": PROMPTS})["clip_text_embeddings"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert sorted(embedder._cache) == sorted(set(PROMPTS))
    calls = []
    monkeypatch.setattr(tower, "forward", lambda *a, **k: calls.append(a))
    again = embedder({"text_prompts": PROMPTS[::-1]})["clip_text_embeddings"]
    assert not calls
    np.testing.assert_array_equal(again.numpy(), got.numpy()[::-1])


@pytest.mark.parametrize("temporal", [False, True])
def test_t5_text_embedder_real_path_writes_the_mask(monkeypatch, temporal):
    """The T5 embedder's real path: hidden states at 2e-5, the int32
    `text_attention_mask` (B, L) equal to JAX's, (B, 1, L, D) with
    `include_temporal`."""
    from xdiffusion_tpu.layers import embedding as jemb

    from xdiffusion_tpu_torch.layers import embedding as pemb

    jmod, jparams, tower = t5_pair(t5_kwargs(), seed=11)
    version, tok = "stand-in/t5", StandInTokenizer(pad_id=0)
    monkeypatch.setitem(jemb._FrozenEncoderCache._loaded, ("t5", version),
                        (jmod.config, jparams, tok))
    monkeypatch.setitem(pemb._FrozenEncoderCache._loaded, ("t5", version),
                        (tower.config, tower, tok))
    args = dict(max_length=12, version=version, embedding_dim=32, context_key="text_embeddings",
                include_temporal=temporal)
    want = jemb.T5TextEmbedder(**args)({"text_prompts": PROMPTS})
    got = pemb.T5TextEmbedder(**args)({"text_prompts": PROMPTS})
    assert sorted(got) == sorted(want) == ["text_attention_mask", "text_embeddings",
                                           "text_prompts"]
    shape = (6, 1, 12, 32) if temporal else (6, 12, 32)
    assert tuple(got["text_embeddings"].shape) == shape
    np.testing.assert_allclose(got["text_embeddings"].numpy(),
                               np.asarray(want["text_embeddings"]), atol=TOL, rtol=0)
    assert got["text_attention_mask"].dtype == torch.int32
    np.testing.assert_array_equal(got["text_attention_mask"].numpy(),
                                  np.asarray(want["text_attention_mask"]))


def test_frozen_clip_embedder_real_path_matches_jax():
    """JAX runs transformers' FlaxCLIPTextModel there (here a stand-in that
    returns the flax tower's `last_hidden_state`); the port its own tower:
    (B, L, D) at 2e-5."""
    from xdiffusion_tpu.layers.clip import FrozenCLIPEmbedder as JaxEmbedder

    from xdiffusion_tpu_torch.layers.clip import FrozenCLIPEmbedder

    jmod, jparams, tower = clip_pair(clip_kwargs(), seed=13)
    tok, apply = StandInTokenizer(), jax.jit(jmod.apply)
    jax_embedder = JaxEmbedder(max_length=N, embedding_dim=32)
    jax_embedder._tokenizer = tok
    jax_embedder._model = lambda input_ids: types.SimpleNamespace(
        last_hidden_state=apply(jparams, jnp.asarray(input_ids))[0])
    want = np.asarray(jax_embedder({"text_prompts": PROMPTS})["text_embeddings"])
    embedder = FrozenCLIPEmbedder(max_length=N, embedding_dim=32)
    embedder._load_attempted, embedder._loaded = True, (tower.config, tower, tok)
    got = embedder({"text_prompts": PROMPTS})["text_embeddings"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, N, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("clip2_width", [24, 8])
def test_sd3_encoder_stack_matches_jax(clip2_width):
    """Two CLIP towers with projections and a T5 encoder: CLIP widths 32 +
    24 = 56 > T5's 32 (T5 zero-padded) and 32 + 8 = 40 < T5's 48 (CLIP
    zero-padded); the stack alone and through the preprocessor
    (`encoders=`): the (B, 2 * 10, W) sequence and the joined pooled vector
    at 2e-5; the prompts leave the context."""
    from xdiffusion_tpu.context import SD3EncoderStack as JaxStack
    from xdiffusion_tpu.context import SD3TextPromptsPreprocessor as JaxPre

    from xdiffusion_tpu_torch.context import SD3EncoderStack, SD3TextPromptsPreprocessor

    j1, p1, t1 = clip_pair(clip_kwargs(projection_dim=16), seed=15)
    j2, p2, t2 = clip_pair(clip_kwargs(hidden_size=clip2_width, num_attention_heads=2,
                                       projection_dim=12, hidden_act="gelu"), seed=16)
    t5_width = 32 if clip2_width == 24 else 48
    jt, pt, tt = t5_pair(t5_kwargs(d_model=t5_width), seed=17)

    def tokenize(prompts, max_length):
        return StandInTokenizer()(prompts, max_length=max_length)["input_ids"].astype(np.int32)

    jstack = JaxStack((j1, p1, tokenize), (j2, p2, tokenize), (jt, pt, tokenize), 10, 10, 10)
    pstack = SD3EncoderStack((t1.config, t1, tokenize), (t2.config, t2, tokenize),
                             (tt.config, tt, tokenize), 10, 10, 10)
    (want_seq, want_pooled), (got_seq, got_pooled) = jstack(PROMPTS), pstack(PROMPTS)
    assert got_seq.shape == (6, 20, max(32 + clip2_width, t5_width))
    assert got_pooled.shape == (6, 16 + 12)
    np.testing.assert_allclose(got_seq, want_seq, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_pooled, want_pooled, atol=TOL, rtol=0)
    want = JaxPre(encoders=jstack)({"text_prompts": PROMPTS, "classes": 1})
    got = SD3TextPromptsPreprocessor(encoders=pstack)({"text_prompts": PROMPTS, "classes": 1})
    assert sorted(got) == sorted(want) == ["classes", "pooled_text_embeddings",
                                           "text_embeddings"]
    for key in ("text_embeddings", "pooled_text_embeddings"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=TOL, rtol=0)


class StandInClap(torch.nn.Module):
    """The call surface of transformers' ClapTextModelWithProjection: a
    mean-pooled embedding table and a projection -> `text_embeds`."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.table = torch.nn.Parameter(torch.randn(VOCAB, 16, generator=gen))
        self.proj = torch.nn.Parameter(torch.randn(16, 8, generator=gen))

    def forward(self, input_ids, attention_mask):
        m = attention_mask[..., None].float()
        pooled = (self.table[input_ids] * m).sum(1) / m.sum(1)
        return types.SimpleNamespace(text_embeds=pooled @ self.proj)


def test_clap_real_path_with_a_stand_in_model_matches_jax(monkeypatch):
    """Both packages' CLAP embedders on one injected stand-in model and
    tokenizer (padding to the longest prompt, torch tensors): equal
    embeddings, each prompt kept once."""
    from xdiffusion_tpu.layers.clap import FrozenCLAPTextEmbedder as JaxClap

    from xdiffusion_tpu_torch.layers.clap import FrozenCLAPTextEmbedder

    version, loaded = "stand-in/clap", (StandInClap().eval(), StandInTokenizer(pad_id=0))
    monkeypatch.setitem(JaxClap._loaded, version, loaded)
    monkeypatch.setitem(FrozenCLAPTextEmbedder._loaded, version, loaded)
    want = np.asarray(JaxClap(embedding_dim=8, version=version)({"text_prompts": PROMPTS})[
        "clap_embeddings"])
    embedder = FrozenCLAPTextEmbedder(embedding_dim=8, version=version)
    got = embedder({"text_prompts": PROMPTS})["clap_embeddings"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert sorted(embedder._cache) == sorted(set(PROMPTS))


def test_loaders_find_nothing_without_transformers(tmp_path):
    """With no cached checkpoint, or a local directory but no
    `transformers`, every loader returns None on both sides, and the
    tokenizer paths fall back to the byte-level BPE."""
    from xdiffusion_tpu.layers import text_encoders as jte

    from xdiffusion_tpu_torch.context import SD3EncoderStack
    from xdiffusion_tpu_torch.layers import text_encoders as pte
    from xdiffusion_tpu_torch.layers.clip import FrozenCLIPTextTokenizer
    from xdiffusion_tpu_torch.layers.embedding import T5TextPromptsToTokens

    for version in ("openai/clip-vit-large-patch14", str(tmp_path)):
        assert jte.load_pretrained_clip_text(version) is None
        assert jte.load_pretrained_clip_text(version, with_projection=True) is None
        assert pte.load_pretrained_clip_text(version, device="cpu") is None
        assert pte.load_pretrained_clip_text(version, with_projection=True) is None
    for version in ("google/t5-v1_1-base", str(tmp_path)):
        assert jte.load_pretrained_t5(version) is None
        assert pte.load_pretrained_t5(version) is None
        assert pte.local_tokenizer(version) is None
    assert not pte.locally_cached("google/t5-v1_1-base")
    assert pte.locally_cached(str(tmp_path))
    assert SD3EncoderStack.for_pretrained(str(tmp_path), "a/b", "c/d", 77, 77, 77) is None
    assert FrozenCLIPTextTokenizer(version=str(tmp_path))._tokenizer is None
    assert T5TextPromptsToTokens(model_name=str(tmp_path))._tokenizer is None


# The published text configs the SD3 stack loads.
FULL_WIDTH = {
    "clip-vit-large-patch14": ("clip", dict(clip_kwargs(), vocab_size=49408, hidden_size=768,
                                            intermediate_size=3072, num_hidden_layers=12,
                                            num_attention_heads=12, max_position_embeddings=77,
                                            eos_token_id=49407, projection_dim=768)),
    "CLIP-ViT-bigG-14": ("clip", dict(clip_kwargs(), vocab_size=49408, hidden_size=1280,
                                      intermediate_size=5120, num_hidden_layers=32,
                                      num_attention_heads=20, max_position_embeddings=77,
                                      hidden_act="gelu", eos_token_id=49407,
                                      projection_dim=1280)),
    "t5-v1_1-base": ("t5", t5_kwargs(vocab_size=32128, d_model=768, d_kv=64, d_ff=2048,
                                     num_layers=12, num_heads=12)),
}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_towers_have_jax_parameter_shapes(name):
    """Each published tower built on the meta device (no memory, no
    compute): its flax paths and shapes, in flax's layout through the
    bridge's axes, equal jax.eval_shape of the JAX tower's init."""
    from xdiffusion_tpu.layers import text_encoders as jte

    from xdiffusion_tpu_torch.layers import text_encoders as pte
    from xdiffusion_tpu_torch.weights import KERNEL_AXES, flax_paths

    kind, kw = FULL_WIDTH[name]
    if kind == "clip":
        jmod, tower_cls, cfg = jte.CLIPTextTransformer(jte.CLIPTextConfig(**kw)), \
            pte.CLIPTextTransformer, pte.CLIPTextConfig(**kw)
    else:
        jmod, tower_cls, cfg = jte.T5Encoder(jte.T5Config(**kw)), pte.T5Encoder, \
            pte.T5Config(**kw)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    want = {"/".join(k): tuple(v.shape)
            for k, v in traverse_util.flatten_dict(shapes["params"]).items()}
    with torch.device("meta"):
        tower = tower_cls(cfg)
    params = dict(tower.named_parameters())
    got = {}
    for pname, path in flax_paths(tower).items():
        shape = tuple(params[pname].shape)
        if pname.endswith(".weight") and path.endswith("kernel"):
            shape = tuple(np.empty(shape, dtype=np.bool_).transpose(
                np.argsort(KERNEL_AXES[len(shape)])).shape)
        got[path] = shape
    assert got == want
    total = sum(int(np.prod(s)) for s in want.values())
    assert total == sum(p.numel() for p in params.values())
