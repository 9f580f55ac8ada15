"""Multimodal (vision-language) session runner: LLaVA-class image input.

Port of ``trackiellm_tpu/llm/vlm.py``. ``VLMRunner`` extends
:class:`trackiellm_tpu_torch.llm.runner.LLMRunner` with image prompts:
``generate("Describe <image>", images=[frame])`` encodes each image through
the CLIP tower and projector (models/clip.py) on the runner's device,
splices the projected features over the image placeholder rows of the
prompt embedding, and ingests the result through
``prefill/extend(embeds=...)``. Decoding (k-token lookahead, grammars, stop
strings, streaming UTF-8) is the base runner's: generation is pure text.

A frame may be a numpy array or a tensor on any device, as the cortex
holds camera frames as tensors already on the card: it is normalized where
it lies (on the runner's device), and only its digest reads its bytes on
the host.

Cross-turn prefix reuse stays exact with images: committed image runs
carry a content digest; a new prompt may reuse the cache only up to the
first position where text tokens or (position, length, digest) of an image
run disagree, so a different image at the same spot rolls the cache back to
before it (rows past ``length`` are masked, the lookahead-rollback
contract).
"""

from __future__ import annotations

import hashlib
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trackiellm_tpu_torch.llm.runner import (EXTEND_BUCKETS, PREFILL_BUCKETS,
                                             GenerationConfig, LLMRunner,
                                             ToolDefinition, _bucket_for)
from trackiellm_tpu_torch.models import clip as clip_model
from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

log = logging.getLogger("trackiellm_tpu_torch.llm.vlm")

# (start, n_tokens, digest) of an image run committed to the KV cache.
_Run = Tuple[int, int, bytes]


class VLMRunner(LLMRunner):
    """LLMRunner + image prompts (LLaVA-class multimodal)."""

    IMAGE_MARKER = "<image>"
    # Filler id written at image rows (the spliced embeddings replace it;
    # any in-vocab id works).
    IMAGE_FILLER_ID = 0

    def __init__(self, params, cfg, clip_params, clip_cfg,
                 tokenizer=None, gen_config: Optional[GenerationConfig] = None,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None,
                 prefix_lm: bool = False):
        """``prefix_lm``: PaliGemma-style inference. The whole input prompt
        attends bidirectionally (models/llm.py prefill ``bidir_len``), so
        every prompt ingests as one prefill bucket (no chunking, no
        cross-turn prefix reuse: a changed suffix changes every prefix
        hidden state). Generated tokens decode causally."""
        super().__init__(params, cfg, tokenizer=tokenizer,
                         gen_config=gen_config, cache_dtype=cache_dtype,
                         device=device)
        self.clip_params = clip_params
        self.clip_cfg = clip_cfg
        self.prefix_lm = prefix_lm
        self._image_runs: List[_Run] = []
        # Cached rows the last multimodal prompt reused (0: ingested fresh).
        self.last_reuse = 0

    # -- image encoding ----------------------------------------------------

    def encode_image(self, image) -> torch.Tensor:
        """Image -> (n_image_tokens, llm_dim) projected f32 features on the
        runner's device.

        Takes an HWC uint8 camera frame (resized and CLIP-normalized on the
        device) or pre-normalized (3, S, S) float ``pixel_values``, as a
        numpy array or a tensor on any device."""
        if not isinstance(image, torch.Tensor):
            image = np.asarray(image)
        if image.ndim != 3:
            raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                               f"expected an image, got shape "
                               f"{tuple(image.shape)}")
        if image.dtype in (np.uint8, torch.uint8):
            px = clip_model.preprocess_clip(image, self.clip_cfg,
                                            device=self.device)
        else:
            if image.shape[0] != 3:
                raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                                   "float image input must be CHW "
                                   "pixel_values")
            px = torch.as_tensor(image).to(self.device, torch.float32)
        return clip_model.encode_and_project(self.clip_params, self.clip_cfg,
                                             px)

    @staticmethod
    def _digest(image) -> bytes:
        """SHA-1 of the image's bytes: equal for equal bytes whether the
        image is a numpy array or a tensor on the card (copied to the host
        for this alone)."""
        if isinstance(image, torch.Tensor):
            image = image.detach().contiguous().cpu().numpy()
        return hashlib.sha1(
            np.ascontiguousarray(np.asarray(image)).tobytes()).digest()

    # -- multimodal prompt ingestion ----------------------------------------

    def prepare_generation(self, prompt: str,
                           tools: Sequence[ToolDefinition] = (),
                           force_tool_call: bool = False,
                           response_schema: Optional[Dict[str, Any]] = None,
                           json_mode: bool = False,
                           images: Sequence[Any] = ()) -> None:
        if not images and not self._image_runs and not self.prefix_lm:
            # Pure text and no image rows in the cache: the base path
            # (priming and prefix reuse included) is exact.
            super().prepare_generation(
                prompt, tools, force_tool_call,
                response_schema=response_schema, json_mode=json_mode)
            return
        segs = prompt.split(self.IMAGE_MARKER)
        if len(segs) - 1 != len(images):
            raise TrackieError(
                ErrorCode.INVALID_ARGUMENT,
                f"prompt has {len(segs) - 1} {self.IMAGE_MARKER} markers "
                f"but {len(images)} images were given")
        self._drop_pending_lookahead()
        self._drop_pending_spec()
        self._primed_ids = None  # text priming does not compose with images

        n_img = self.clip_cfg.n_image_tokens
        ids: List[int] = self.tokenizer.encode(segs[0], add_bos=True)
        runs: List[Tuple[int, int, bytes, torch.Tensor]] = []
        for image, seg in zip(images, segs[1:]):
            feats = self.encode_image(image)
            runs.append((len(ids), n_img, self._digest(image), feats))
            ids.extend([self.IMAGE_FILLER_ID] * n_img)
            if seg:
                ids.extend(self.tokenizer.encode(seg, add_bos=False))

        hard_limit = self.max_prompt_tokens
        if len(ids) > hard_limit:
            # The base runner middle-cuts oversized text prompts; a cut
            # crossing an image run would tear its embedding block, so an
            # overflow is an error here (budget prompts upstream).
            raise TrackieError(
                ErrorCode.CONTEXT_OVERFLOW,
                f"multimodal prompt of {len(ids)} tokens exceeds the "
                f"{hard_limit}-token window budget")

        if self.prefix_lm:
            self._ingest_prefix_lm(ids, runs)
        else:
            self._ingest_multimodal(ids, runs)
        self._arm_generation_state(tools, force_tool_call,
                                   response_schema, json_mode)

    def _ingest_prefix_lm(self, ids: List[int], runs) -> None:
        """One bidirectional prefill over the whole prompt (PaliGemma's
        inference semantics)."""
        buckets = ([b for b in PREFILL_BUCKETS if b <= self.cfg.max_seq]
                   or [self.cfg.max_seq])
        if len(ids) > buckets[-1]:
            raise TrackieError(
                ErrorCode.CONTEXT_OVERFLOW,
                f"prefix-LM prompt of {len(ids)} tokens exceeds the "
                f"largest prefill bucket {buckets[-1]} (bidirectional "
                f"attention cannot be chunked)")
        bucket = _bucket_for(len(ids), buckets)
        padded = np.zeros(bucket, np.int64)
        padded[: len(ids)] = ids
        self.cache = self.cache._replace(length=0)
        logits, self.cache = llm_model.prefill(
            self.params, self.cfg, self._ids(padded), len(ids), self.cache,
            embeds=self._chunk_embeds(padded, 0, runs), bidir_len=len(ids))
        self._host_len = len(ids)
        self._committed_ids = list(ids)
        self._pending_spec = []
        self._next_logits = logits
        self._image_runs = [(s, n, d) for (s, n, d, _) in runs]
        self.last_reuse = 0

    def _ingest_multimodal(self, ids: List[int], runs) -> None:
        """Digest-aware prefix reuse, then embeds-spliced prefill/extend."""
        committed = self._committed_ids
        lcp = 0
        limit = min(len(committed), len(ids))
        while lcp < limit and committed[lcp] == ids[lcp]:
            lcp += 1
        # Image runs inside the shared prefix must agree on (start, n,
        # digest) pairwise in order; the reuse stops at the first
        # disagreement (text equality alone cannot tell filler rows apart).
        new_runs: List[_Run] = [(s, n, d) for (s, n, d, _) in runs]
        for old, new in zip(self._image_runs, new_runs):
            if old != new:
                lcp = min(lcp, min(old[0], new[0]))
                break
        else:
            longer = (self._image_runs[len(new_runs):]
                      or new_runs[len(self._image_runs):])
            if longer:
                lcp = min(lcp, longer[0][0])
        lcp = min(lcp, len(ids) - 1)

        if lcp >= self.PREFIX_REUSE_MIN:
            self.cache = self.cache._replace(length=lcp)
            self._host_len = lcp
            del self._committed_ids[lcp:]
            self._pending_spec = []
            start_at = self.last_reuse = lcp
            log.info("multimodal prefix reuse: %d/%d tokens in cache",
                     lcp, len(ids))
        else:
            # Fresh ingestion: the head bucket through prefill, the rest
            # chunked.
            buckets = ([b for b in PREFILL_BUCKETS if b <= self.cfg.max_seq]
                       or [self.cfg.max_seq])
            first_n = min(len(ids), buckets[-1])
            padded = np.zeros(_bucket_for(first_n, buckets), np.int64)
            padded[:first_n] = ids[:first_n]
            self.cache = self.cache._replace(length=0)
            logits, self.cache = llm_model.prefill(
                self.params, self.cfg, self._ids(padded), first_n,
                self.cache, embeds=self._chunk_embeds(padded, 0, runs))
            self._host_len = first_n
            self._committed_ids = list(ids[:first_n])
            self._pending_spec = []
            self._next_logits = logits
            start_at, self.last_reuse = first_n, 0

        pos = start_at
        logits = self._next_logits
        while pos < len(ids):
            chunk = ids[pos: pos + EXTEND_BUCKETS[-1]]
            logits = self._extend_ids_embeds(chunk, pos, runs)
            pos += len(chunk)
        self._next_logits = logits
        self._image_runs = new_runs

    def _chunk_embeds(self, padded: np.ndarray, lo: int, runs
                      ) -> torch.Tensor:
        """Token embeddings of a padded chunk starting at prompt position
        ``lo``, with every overlapping image run's projected features over
        its rows."""
        x = llm_model.embed_tokens(self.params, self._ids(padded))
        hi = lo + len(padded)
        for (s, n, _d, feats) in runs:
            a, b = max(s, lo), min(s + n, hi)
            if a < b:
                x[a - lo: b - lo] = feats[a - s: b - s].to(x.dtype)
        return x

    def _extend_ids_embeds(self, chunk: List[int], lo: int, runs
                           ) -> torch.Tensor:
        padded = np.zeros(_bucket_for(len(chunk), EXTEND_BUCKETS), np.int64)
        padded[: len(chunk)] = chunk
        logits, self.cache = llm_model.extend(
            self.params, self.cfg, self._ids(padded), len(chunk), self.cache,
            attn_len=self._attn_bucket_for(self._host_len + len(padded)),
            embeds=self._chunk_embeds(padded, lo, runs))
        self._host_len += len(chunk)
        self._committed_ids.extend(int(i) for i in chunk)
        return logits

    def prime(self, prompt_prefix: str) -> None:
        """Mid-utterance priming prefills causally, which means nothing
        under prefix-LM semantics (the final prompt prefills
        bidirectionally anyway), so it is a no-op there."""
        if self.prefix_lm:
            log.debug("prime() ignored in prefix-LM mode")
            return
        super().prime(prompt_prefix)

    # -- public API ----------------------------------------------------------

    def generate(self, prompt: str, tools: Sequence[ToolDefinition] = (),
                 force_tool_call: bool = False,
                 on_token: Optional[Callable[[str], None]] = None,
                 should_stop: Optional[Callable[[], bool]] = None,
                 response_schema: Optional[Dict[str, Any]] = None,
                 json_mode: bool = False,
                 images: Sequence[Any] = ()) -> str:
        """Full multimodal generation (the base semantics + ``images``)."""
        self.prepare_generation(prompt, tools, force_tool_call,
                                response_schema=response_schema,
                                json_mode=json_mode, images=images)
        while (piece := self.generate_next_token()) is not None:
            if on_token:
                on_token(piece)
            if should_stop is not None and should_stop():
                self._done = True
                break
        self._drop_pending_spec()
        self._drop_pending_lookahead()
        tail = self._flush_text()
        if tail and on_token:
            on_token(tail)
        return self._generated_text

    def reset(self) -> None:
        super().reset()
        self._image_runs = []
