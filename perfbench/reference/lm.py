"""Plain float32 reference of ACE-Step's 5 Hz planner (acestep-5Hz-lm-*, a
Qwen3 causal LM with 64,000 `<|audio_code_N|>` ids added to its
vocabulary) and of the planner's mathematics around it.

The forward pass follows the published Qwen3 block: token embedding, then
per layer RMSNorm, q/k/v projections, per-head RMSNorm of q and k,
rotate-half RoPE (theta from the config), causal grouped-query attention
with a 1/sqrt(head_dim) scale, o projection and residual, RMSNorm, SwiGLU
(down(silu(gate) * up)) and residual; then the final RMSNorm and the head
over every id of the vocabulary. One stream at a time over all its tokens:
no cache, no batching, no padding. Parameters are a dict of float32
tensors under the state-dict names the benchmark's weights carry
(`embed_tokens`, `layers.<i>.self_attn.q_proj.weight`, ...,
`lm_head.weight` when the head is untied).

Around it, the planner's mathematics:

- `Tokenizer`: the char-level tokenizer the program builds when no
  checkpoint's tokenizer is present: six specials, the audio codes, then
  printable ASCII and two accidentals, a special wherever its whole
  text stands;
- `cot_prompt`, `codes_prompt`, `format_cot`, `cot_fields`: the two
  prompts of each phase (conditional and unconditional) rebuilt from the
  caption, the lyrics and the CoT, as the planner's ChatML template
  writes them;
- `cfg_mix`: u + s * (c - u) of a conditional and an unconditional
  stream's logits;
- `allowed_sets`: the set the CoT's finite-state machine allows at each
  step, from an FSM object (`next_mask()`, `advance(token)`) walked over
  the emitted tokens;
- `code_window`: the ids phase 2 samples among.

Departures from the published description: RoPE tables are computed in
float64 and rounded to float32 (the published code builds them in float32);
the vocabulary is the Qwen3 vocabulary plus the 64,000 audio codes, with
the tokenizer above in place of Qwen's BPE, so only its first ids are
ever fed; the attention softmax masks with the most negative float32
rather than -inf (no row is ever fully masked in a causal stream, so the
values are the same).

Imports nothing but torch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

INSTRUCTION = "Generate audio semantic tokens based on the given conditions:"
NEGATIVE = "NO USER INPUT"
COT_KEYS = ("bpm", "caption", "duration", "keyscale", "language",
            "timesignature")


# ------------------------------------------------------------------
# Parameters
# ------------------------------------------------------------------


def param_shapes(lm: dict) -> Dict[str, tuple]:
    """Every tensor of the planner: {name: shape}."""
    h, inter = lm["hidden_size"], lm["intermediate_size"]
    nq, nkv, d = (lm["num_attention_heads"], lm["num_key_value_heads"],
                  lm["head_dim"])
    out = {"embed_tokens": (lm["vocab_size"], h), "norm.scale": (h,)}
    for i in range(lm["num_hidden_layers"]):
        p = f"layers.{i}"
        out.update({f"{p}.input_layernorm.scale": (h,),
                    f"{p}.post_attention_layernorm.scale": (h,),
                    f"{p}.self_attn.q_proj.weight": (nq * d, h),
                    f"{p}.self_attn.k_proj.weight": (nkv * d, h),
                    f"{p}.self_attn.v_proj.weight": (nkv * d, h),
                    f"{p}.self_attn.o_proj.weight": (h, nq * d),
                    f"{p}.self_attn.q_norm.scale": (d,),
                    f"{p}.self_attn.k_norm.scale": (d,),
                    f"{p}.mlp.gate.weight": (inter, h),
                    f"{p}.mlp.up.weight": (inter, h),
                    f"{p}.mlp.down.weight": (h, inter)})
    if not lm["tie_word_embeddings"]:
        out["lm_head.weight"] = (lm["vocab_size"], h)
    return out


# ------------------------------------------------------------------
# Forward (float32)
# ------------------------------------------------------------------


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(L: int, d: int, theta: float, device) -> Tuple[Tensor, Tensor]:
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                        device=device) / half))
    f = torch.arange(L, dtype=torch.float64, device=device)[:, None] * inv
    emb = torch.cat([f, f], -1)
    return emb.cos().float(), emb.sin().float()


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x (L, H, D)."""
    x1, x2 = x.chunk(2, -1)
    return x * cos[:, None] + torch.cat([-x2, x1], -1) * sin[:, None]


def attention(W: dict, p: str, x: Tensor, cos: Tensor, sin: Tensor,
              lm: dict) -> Tensor:
    """Causal GQA self-attention of one stream x (L, H)."""
    L = x.shape[0]
    nq, nkv, d = (lm["num_attention_heads"], lm["num_key_value_heads"],
                  lm["head_dim"])
    eps = lm["rms_norm_eps"]
    q = rms_norm((x @ W[f"{p}.q_proj.weight"].T).view(L, nq, d),
                 W[f"{p}.q_norm.scale"], eps)
    k = rms_norm((x @ W[f"{p}.k_proj.weight"].T).view(L, nkv, d),
                 W[f"{p}.k_norm.scale"], eps)
    v = (x @ W[f"{p}.v_proj.weight"].T).view(L, nkv, d)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    rep = nq // nkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~causal, torch.finfo(torch.float32).min)
    o = torch.einsum("hqk,khd->qhd", logits.softmax(-1), v)
    return o.reshape(L, nq * d) @ W[f"{p}.o_proj.weight"].T


def hidden(W: dict, lm: dict, ids: Sequence[int]) -> Tensor:
    """The final-norm hidden states (L, H) of one stream of token ids."""
    dev = W["embed_tokens"].device
    ids = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
    x = W["embed_tokens"][ids]
    cos, sin = rope(len(ids), lm["head_dim"], lm["rope_theta"], dev)
    eps = lm["rms_norm_eps"]
    for i in range(lm["num_hidden_layers"]):
        p = f"layers.{i}"
        x = x + attention(W, f"{p}.self_attn",
                          rms_norm(x, W[f"{p}.input_layernorm.scale"], eps),
                          cos, sin, lm)
        h = rms_norm(x, W[f"{p}.post_attention_layernorm.scale"], eps)
        x = x + (F.silu(h @ W[f"{p}.mlp.gate.weight"].T)
                 * (h @ W[f"{p}.mlp.up.weight"].T)) @ W[f"{p}.mlp.down.weight"].T
    return rms_norm(x, W["norm.scale"], eps)


def logits(W: dict, lm: dict, ids: Sequence[int], positions: Sequence[int],
           lo: int = 0, hi: Optional[int] = None, block: int = 128) -> Tensor:
    """Logits (len(positions), hi - lo) of the stream `ids` at `positions`
    (the logits there predict the token after each): the head over the
    whole vocabulary, in blocks of `block` positions, then the window
    [lo, hi). TF32 is turned off first: on the card a float32 product
    would otherwise round its operands to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    head = W["embed_tokens"] if lm["tie_word_embeddings"] \
        else W["lm_head.weight"]
    hi = head.shape[0] if hi is None else hi
    h = hidden(W, lm, ids)
    pos = torch.as_tensor(list(positions), dtype=torch.long, device=h.device)
    out = [(h[pos[a:a + block]] @ head.T)[:, lo:hi]
           for a in range(0, len(pos), block)]
    return torch.cat(out) if out else h.new_zeros((0, hi - lo))


def cfg_mix(cond: Tensor, uncond: Tensor, scale: float) -> Tensor:
    """The paired-CFG mix u + s * (c - u)."""
    return uncond + scale * (cond - uncond)


# ------------------------------------------------------------------
# Tokenizer (the program's fallback, without checkpoint files)
# ------------------------------------------------------------------


class Tokenizer:
    """Specials `<|im_start|>`, `<|im_end|>` (end of turn, the EOS),
    `<|endoftext|>` (the pad), `<think>`, `</think>`, newline, then
    `<|audio_code_0|>` ... `<|audio_code_{n-1}|>`, then the printable
    ASCII characters and the accidentals U+266F and U+266D, one id each;
    an unknown character encodes as the pad."""

    def __init__(self, num_audio_codes: int):
        specials = ["<|im_start|>", "<|im_end|>", "<|endoftext|>",
                    "<think>", "</think>", "\n"]
        specials += [f"<|audio_code_{i}|>" for i in range(num_audio_codes)]
        chars = [chr(c) for c in range(32, 127)] + ["♯", "♭"]
        self.texts = specials + chars
        self.ids = {t: i for i, t in enumerate(self.texts)}
        self.eos, self.pad = self.ids["<|im_end|>"], self.ids["<|endoftext|>"]
        self.num_audio_codes = num_audio_codes

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        i = 0
        while i < len(text):
            if text[i] == "<":
                j = text.find(">", i)
                special = text[i:j + 1] if j > i else ""
                if special in self.ids:
                    out.append(self.ids[special])
                    i = j + 1
                    continue
            out.append(self.ids.get(text[i], self.pad))
            i += 1
        return out

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.texts[i] for i in ids if 0 <= i < len(self.texts))

    def code_id(self, n: int) -> int:
        return 6 + n


def code_window(tok: Tokenizer) -> Tuple[int, int]:
    """[lo, hi): the ids of the audio codes, which phase 2 samples among."""
    return tok.code_id(0), tok.code_id(tok.num_audio_codes)


# ------------------------------------------------------------------
# Prompts
# ------------------------------------------------------------------


def chat(messages: Sequence[Tuple[str, str]], generation_prompt: bool) -> str:
    """Qwen's ChatML: each turn `<|im_start|>role\\ncontent<|im_end|>\\n`,
    then `<|im_start|>assistant\\n` to open the reply, or, without it, the
    last turn left open (its `<|im_end|>\\n` dropped)."""
    text = "".join(f"<|im_start|>{r}\n{c}<|im_end|>\n" for r, c in messages)
    if generation_prompt:
        return text + "<|im_start|>assistant\n"
    return text[:-len("<|im_end|>\n")]


def _system() -> Tuple[str, str]:
    return ("system", f"# Instruction\n{INSTRUCTION}\n\n")


def cot_prompt(caption: str, lyrics: str, negative: bool = False) -> str:
    """Phase 1's prompt; the unconditional one keeps only the lyrics (the
    negative prompt is the default "NO USER INPUT")."""
    user = (f"# Lyric\n{lyrics}\n" if negative
            else f"# Caption\n{caption}\n\n# Lyric\n{lyrics}\n")
    return chat([_system(), ("user", user)], True)


def codes_prompt(caption: str, lyrics: str, cot: str,
                 negative: bool = False) -> str:
    """Phase 2's prompt: phase 1's turns with the CoT as the assistant's
    open reply; the unconditional one carries an empty think block."""
    reply = "<think>\n</think>" if negative else cot
    text = chat([_system(),
                 ("user", f"# Caption\n{caption}\n\n# Lyric\n{lyrics}\n"),
                 ("assistant", reply)], False)
    return text if text.endswith("\n") else text + "\n"


def cot_fields(text: str) -> Dict[str, str]:
    """The `key: value` lines of a CoT's think block (the first line of
    each key's value, stripped), for the keys the schema has."""
    a = text.find("<think>")
    b = text.find("</think>", a + 1) if a >= 0 else -1
    body = text[a + len("<think>"):b] if b >= 0 else text
    out: Dict[str, str] = {}
    for line in body.split("\n"):
        if not line or line[0].isspace() or ":" not in line:
            continue
        k, v = line.split(":", 1)
        k = k.strip().lower()
        if k in COT_KEYS and v.strip():
            out[k] = v.strip()
    return out


def format_cot(fields: Dict[str, str]) -> str:
    """The CoT phase 2 is conditioned on: the fields sorted by key, a
    time signature `n/4` written `n`, a value of digits written as its
    number."""
    items = {}
    for k in COT_KEYS:
        v = fields.get(k)
        if not v:
            continue
        if k == "timesignature" and v.endswith("/4"):
            v = v.split("/")[0]
        items[k] = str(int(v)) if v.isdigit() else v
    body = "\n".join(f"{k}: {items[k]}" for k in sorted(items))
    return f"<think>\n{body}\n</think>"


# ------------------------------------------------------------------
# The CoT's allowed sets
# ------------------------------------------------------------------


def allowed_sets(fsm, tokens: Sequence[int]) -> List[Optional[set]]:
    """The ids `fsm` allows before each of `tokens`, walking it over them
    (None where it allows every id)."""
    out: List[Optional[set]] = []
    for t in tokens:
        m = fsm.next_mask()
        out.append(None if m is None else
                   set(int(i) for i in torch.as_tensor(m).nonzero()[:, 0]))
        fsm.advance(int(t))
    return out
