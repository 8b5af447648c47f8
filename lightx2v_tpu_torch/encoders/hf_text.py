"""HunyuanVideo's HF text encoders on the port's own towers (counterpart of
``lightx2v_tpu.encoders.hf_text``): the same model directories and
constructor arguments, no ``transformers`` model.

``TextEncoderHFLlamaModel`` reads an HF Llama directory (``config.json``,
safetensors, the tokenizer files) into ``encoders/llama.py``'s tower: the
states after ``num_layers - hidden_state_skip_layer`` blocks (HF's
``hidden_states[-(skip + 1)]``) with the template's first ``crop_start``
tokens cropped, prompts padded to ``crop_start + 256``.
``TextEncoderHFClipModel`` reads an HF ``CLIPTextModel`` (or ``CLIPModel``)
directory into ``encoders/clip.py``'s text tower: the pooled vector at 77
tokens, pooled by HF's rule for the config's ``eos_token_id``. The weights
go to ``device`` (the card unless the caller asks for the CPU) tensor by
tensor; the towers run bf16 there, where the JAX package runs
``transformers`` in fp16 on the CPU. The tokenizers are ``HFTokenizer``s,
which import ``transformers`` at their first call; set ``.tokenizer`` to
another callable to run without it.

``TextEncoderHFLlavaModel`` (Hunyuan i2v's Llava encoder, which no JAX
runner reaches) raises ``NotImplementedError``."""

from __future__ import annotations

from ..utils.device import resolve_device
from ..utils.safetensors_io import read_config
from .clip import CLIPTextModel, clip_text_arch_from_config, load_clip_text_dir
from .llama import LLAVA_LLAMA3_8B, PROMPT_TEMPLATE, LlamaEncoderModel, llama_arch_from_config, load_llama_dir
from .tokenizer import HFTokenizer

CLIP_MAX_LENGTH = 77  # the JAX encoder pads every prompt to 77 tokens


class TextEncoderHFLlamaModel(LlamaEncoderModel):
    """An HF Llama directory -> ``LlamaEncoderModel``: ``infer(texts)`` gives
    (states (B, 256, dim) bf16 on the device, mask (B, 256) numpy)."""

    def __init__(self, model_path: str, device="cuda", crop_start: int = LLAVA_LLAMA3_8B.crop_start,
                 hidden_state_skip_layer: int = 2, prompt_template: str = PROMPT_TEMPLATE):
        arch = llama_arch_from_config(read_config(model_path), crop_start, hidden_state_skip_layer)
        super().__init__(arch, load_llama_dir(model_path, arch, resolve_device(device)),
                         HFTokenizer(model_path, arch.max_length), prompt_template)


class TextEncoderHFClipModel(CLIPTextModel):
    """An HF CLIP text directory -> ``CLIPTextModel``: ``infer(texts)`` gives
    the pooled vectors (B, dim) fp32 on the device."""

    def __init__(self, model_path: str, device="cuda"):
        arch = clip_text_arch_from_config(read_config(model_path))
        super().__init__(arch, load_clip_text_dir(model_path, arch, resolve_device(device)),
                         HFTokenizer(model_path, CLIP_MAX_LENGTH))


class TextEncoderHFLlavaModel:
    """Hunyuan i2v's Llava text + image encoder: not ported."""

    def __init__(self, *a, **kw):
        raise NotImplementedError("the Llava text + image encoder (TextEncoderHFLlavaModel) is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 21)")
