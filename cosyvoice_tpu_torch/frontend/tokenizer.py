"""Text tokenizers.

Counterpart of cosyvoice_tpu/frontend/tokenizer.py: the CosyVoice2/3
special-token lists, `QwenTokenizer` (the Qwen2 byte-level BPE of a model
dir's tokenizer assets plus the special tokens, frontend/bpe.py; the JAX
package builds it with `transformers`, which the port does not import),
`ByteFallbackTokenizer` (UTF-8 bytes, then the special tokens; what both
packages use when a model dir ships no tokenizer assets), the
CosyVoice-300M (v1) whisper constants (`whisper_v1_specials`,
WHISPER_PAT_STR) with its `.tiktoken` vocab's tokenizer
(frontend/tiktoken_bpe.py, where the JAX package runs a C++ BPE and the
`regex` module), `find_tokenizer_assets` and `get_tokenizer`.

Where the JAX `get_tokenizer` logs a Qwen tokenizer that fails to load and
falls back to byte ids, the port raises: byte ids do not match a
Qwen-trained LM.
"""

import glob
import os
import re
from typing import List, Optional

from cosyvoice_tpu_torch.frontend.bpe import ByteLevelBPE
from cosyvoice_tpu_torch.frontend.tiktoken_bpe import WHISPER_PAT_STR, TiktokenBPE  # noqa: F401 (re-exported)

# exact paralinguistic special-token inventory (reference tokenizer.py:244-256)
V2_SPECIAL_TOKENS = [
    "<|im_start|>", "<|im_end|>", "<|endofprompt|>",
    "[breath]", "<strong>", "</strong>", "[noise]",
    "[laughter]", "[cough]", "[clucking]", "[accent]",
    "[quick_breath]",
    "<laughter>", "</laughter>",
    "[hissing]", "[sigh]", "[vocalized-noise]",
    "[lipsmack]", "[mn]",
]

# v3 pronunciation-inpainting inventory (reference tokenizer.py:274-306): CMU
# phones with stress digits + toned pinyin syllable pieces
_CMU = (
    "AA AA0 AA1 AA2 AE AE0 AE1 AE2 AH AH0 AH1 AH2 AO AO0 AO1 AO2 AW AW0 AW1 AW2 AY AY0 AY1 AY2 "
    "B CH D DH EH EH0 EH1 EH2 ER ER0 ER1 ER2 EY EY0 EY1 EY2 F G HH IH IH0 IH1 IH2 IY IY0 IY1 IY2 "
    "JH K L M N NG OW OW0 OW1 OW2 OY OY0 OY1 OY2 P R S SH T TH UH UH0 UH1 UH2 UW UW0 UW1 UW2 V W Y Z ZH"
).split()
_PINYIN = (
    "a ai an ang ao b c ch d e ei en eng f g h i ian in ing iu ià iàn iàng iào iá ián iáng iáo iè ié "
    "iòng ióng iù iú iā iān iāng iāo iē iě iōng iū iǎ iǎn iǎng iǎo iǒng iǔ j k l m n o ong ou p q r s sh "
    "t u uang ue un uo uà uài uàn uàng uá uái uán uáng uè ué uì uí uò uó uā uāi uān uāng uē uě uī uō uǎ "
    "uǎi uǎn uǎng uǐ uǒ vè w x y z zh à ài àn àng ào á ái án áng áo è èi èn èng èr é éi én éng ér ì ìn "
    "ìng í ín íng ò òng òu ó óng óu ù ùn ú ún ā āi ān āng āo ē ēi ēn ēng ě ěi ěn ěng ěr ī īn īng ō ōng "
    "ōu ū ūn ǎ ǎi ǎn ǎng ǎo ǐ ǐn ǐng ǒ ǒng ǒu ǔ ǔn ǘ ǚ ǜ"
).split()
V3_EXTRA_SPECIAL_TOKENS = ["<|endofsystem|>"] + [f"[{p}]" for p in _CMU] + [f"[{p}]" for p in _PINYIN]


# v1 whisper-style tokenizer (reference tokenizer.py:11-206): the tiktoken
# vocab asset "multilingual_zh_ja_yue_char_del.tiktoken" plus this special
# inventory, whose order gives the ids after the vocab's lines
_WHISPER_LANGS = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu ta no th ur "
    "hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn bs kk sq sw gl mr pa si "
    "km sn yo so af oc ka be tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha "
    "ba jw su yue minnan wuyu dialect zh/en en/zh"
).split()
_AUDIO_EVENTS = ["ASR", "AED", "SER", "Speech", "/Speech", "BGM", "/BGM",
                 "Laughter", "/Laughter", "Applause", "/Applause"]
_EMOTIONS = ["HAPPY", "SAD", "ANGRY", "NEUTRAL"]
_TTS_VOCAL = ["TTS/B", "TTS/O", "TTS/Q", "TTS/A", "TTS/CO", "TTS/CL", "TTS/H"] + [
    f"TTS/SP{i:02d}" for i in range(1, 14)
]


def whisper_v1_specials(num_languages: int = 99) -> List[str]:
    """The v1 tokenizer's special tokens in id order (reference
    tokenizer.py:179-197)."""
    return [
        "<|endoftext|>",
        "<|startoftranscript|>",
        *[f"<|{lang}|>" for lang in _WHISPER_LANGS[:num_languages]],
        *[f"<|{e}|>" for e in _AUDIO_EVENTS],
        *[f"<|{e}|>" for e in _EMOTIONS],
        "<|translate|>",
        "<|transcribe|>",
        "<|startoflm|>",
        "<|startofprev|>",
        "<|nospeech|>",
        "<|notimestamps|>",
        *[f"<|SPECIAL_TOKEN_{i}|>" for i in range(1, 31)],
        *[f"<|{t}|>" for t in _TTS_VOCAL],
        *[f"<|{i * 0.02:.2f}|>" for i in range(1501)],
    ]


class ByteFallbackTokenizer:
    """UTF-8 byte tokenizer with special-token pass-through: ids 0..255 are
    raw bytes, the special tokens follow the byte range in list order."""

    def __init__(self, special_tokens: Optional[List[str]] = None):
        self.special_tokens = list(special_tokens or V2_SPECIAL_TOKENS)
        self.special_ids = {t: 256 + i for i, t in enumerate(self.special_tokens)}
        self._pattern = re.compile("|".join(re.escape(t) for t in self.special_tokens)) if self.special_tokens else None

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.special_tokens)

    def encode(self, text: str, allowed_special: str = "all") -> List[int]:
        ids: List[int] = []
        pos = 0
        for m in self._pattern.finditer(text) if self._pattern else []:
            ids.extend(text[pos : m.start()].encode("utf-8"))
            ids.append(self.special_ids[m.group(0)])
            pos = m.end()
        ids.extend(text[pos:].encode("utf-8"))
        return ids

    def decode(self, ids: List[int]) -> str:
        out, buf = [], []
        rev = {v: k for k, v in self.special_ids.items()}
        for i in ids:
            if i < 256:
                buf.append(i)
            else:
                if buf:
                    out.append(bytes(buf).decode("utf-8", errors="replace"))
                    buf = []
                out.append(rev.get(i, ""))
        if buf:
            out.append(bytes(buf).decode("utf-8", errors="replace"))
        return "".join(out)


class QwenTokenizer:
    """The Qwen2 BPE of `token_path` (tokenizer.json, or vocab.json +
    merges.txt + tokenizer_config.json) plus the version's special tokens,
    added as the JAX package's QwenTokenizer adds them."""

    def __init__(self, token_path: str, skip_special_tokens: bool = True, version: int = 2):
        special = V2_SPECIAL_TOKENS + (V3_EXTRA_SPECIAL_TOKENS if version >= 3 else [])
        self.tokenizer = ByteLevelBPE.from_dir(token_path)
        self.tokenizer.add_special_tokens(special)
        self.skip_special_tokens = skip_special_tokens

    @property
    def vocab_size(self) -> int:
        return len(self.tokenizer)

    def encode(self, text: str, allowed_special: str = "all") -> List[int]:
        return self.tokenizer.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self.tokenizer.decode(ids, skip_special_tokens=self.skip_special_tokens)


def find_tokenizer_assets(model_dir: Optional[str]) -> Optional[str]:
    """Tokenizer assets inside a released model dir, probed in the JAX
    package's order: a 'tokenizer/' subdir, the HF Qwen pretrain dir the
    released CosyVoice2/3 checkpoints ship ('CosyVoice-BlankEN'), the model
    dir itself, then a v1 *.tiktoken vocab (also under assets/)."""
    if not model_dir:
        return None
    markers = ("tokenizer.json", "tokenizer_config.json", "vocab.json")
    for sub in ("tokenizer", "CosyVoice-BlankEN"):
        d = os.path.join(model_dir, sub)
        if any(os.path.exists(os.path.join(d, m)) for m in markers):
            return d
    if any(os.path.exists(os.path.join(model_dir, m)) for m in markers):
        return model_dir
    tk = sorted(glob.glob(os.path.join(model_dir, "*.tiktoken"))) + sorted(
        glob.glob(os.path.join(model_dir, "assets", "*.tiktoken"))
    )
    return tk[0] if tk else None


def get_tokenizer(token_path: Optional[str] = None, version: int = 2):
    """The v1 tokenizer of a `.tiktoken` vocab (the whisper pre-tokenizer
    and special tokens), the Qwen tokenizer of the assets at `token_path`
    (a dir), or the byte tokenizer with the version's special tokens when
    there are none."""
    if token_path and token_path.endswith(".tiktoken"):
        return TiktokenBPE.from_file(token_path, whisper_v1_specials())
    if token_path:
        return QwenTokenizer(token_path, version=version)
    return ByteFallbackTokenizer(V2_SPECIAL_TOKENS + (V3_EXTRA_SPECIAL_TOKENS if version >= 3 else []))
