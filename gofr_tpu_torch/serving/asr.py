"""ASR serving: batched Whisper transcription behind HTTP and pub/sub
(counterpart of ``gofr_tpu/serving/asr.py``).

:class:`Transcriber` pads audio up to a sample bucket and the batch up
to a batch bucket, as the JAX one does (there each bucket is one
compiled graph; here the batch runs eagerly on the transcriber's
device), and exposes:

- :func:`make_asr_handler`: ``POST /transcribe`` with a float list or
  base64 float32 PCM, one request a device batch;
- :class:`ASRWorker`: the pub/sub batch consumer. It drains up to
  ``max_batch`` audio messages a device batch, publishes each transcript
  to a results topic and commits each message only after its transcript
  is published (at-least-once end to end); a message that does not
  decode is committed and dropped.
- :class:`LoopThread`: an asyncio loop on a thread of its own, for a
  worker beside a threading HTTP server.
"""

from __future__ import annotations

import asyncio
import base64
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..models.whisper import transcribe_audio


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class ASRConfig:
    max_batch: int = 8
    max_tokens: int = 64
    #: audio-length buckets in samples (16 kHz): 1 s, 5 s, 10 s, 30 s
    sample_buckets: tuple[int, ...] = (16000, 80000, 160000, 480000)


class Transcriber:
    """Bucketed batch transcription over a Whisper parameter tree that
    lies on ``device`` (default: CUDA, or raise)."""

    def __init__(self, params: dict, model_config: Any,
                 asr_config: ASRConfig | None = None,
                 tokenizer: Any = None, *,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self.params = params
        self.config = model_config
        self.asr = asr_config if asr_config is not None else ASRConfig()
        self.tokenizer = tokenizer
        self.executions = 0

    def batch_bucket(self, n: int) -> int:
        """The device batch for ``n`` audios: the least of (1, 2, 4,
        ``max_batch``) that holds them."""
        m = self.asr.max_batch
        return _bucket(n, tuple(b for b in (1, 2, 4, m) if b <= m) or (m,))

    def transcribe_batch(self, audios: list[np.ndarray]) -> list[dict]:
        """Pad a list of PCM arrays into one bucketed device batch; one
        result a PCM array: ``tokens`` (up to end-of-text), ``n_tokens``,
        ``batch``, ``samples``, ``execute_ms`` and, with a tokenizer,
        ``text``."""
        if not audios:
            return []
        longest = max(len(a) for a in audios)
        samples = _bucket(longest, self.asr.sample_buckets)
        batch = self.batch_bucket(len(audios))
        padded = np.zeros((batch, samples), np.float32)
        for i, a in enumerate(audios):
            padded[i, :min(len(a), samples)] = a[:samples]
        start = time.perf_counter()
        with torch.inference_mode():
            tokens, lengths = transcribe_audio(
                self.params, torch.from_numpy(padded).to(self.device),
                self.config, max_tokens=self.asr.max_tokens)
            tokens = tokens.cpu().numpy()
            lengths = lengths.cpu().numpy()
        elapsed = time.perf_counter() - start
        self.executions += 1
        out = []
        for i in range(len(audios)):
            toks = tokens[i, :lengths[i]].tolist()
            entry = {"tokens": toks, "n_tokens": int(lengths[i]),
                     "batch": batch, "samples": samples,
                     "execute_ms": round(elapsed * 1000, 2)}
            if self.tokenizer is not None:
                entry["text"] = self.tokenizer.decode(toks)
            out.append(entry)
        return out

    def health_check(self) -> dict:
        return {"status": "UP",
                "details": {"model": "whisper", "executions": self.executions}}


def decode_audio_payload(data: Any) -> np.ndarray:
    """Accept {'audio': [floats]} or {'audio_b64': base64 f32 PCM}."""
    if isinstance(data, dict) and "audio_b64" in data:
        raw = base64.b64decode(data["audio_b64"])
        return np.frombuffer(raw, np.float32).copy()
    if isinstance(data, dict) and "audio" in data:
        return np.asarray(data["audio"], np.float32)
    raise ValueError("payload needs 'audio' (float list) or 'audio_b64'")


def make_asr_handler(transcriber: Transcriber):
    """``POST /transcribe``: one audio, one device batch (201 with the
    result in ``{"data": ...}``)."""

    def transcribe_handler(ctx: Any) -> Any:
        audio = decode_audio_payload(ctx.bind())
        return transcriber.transcribe_batch([audio])[0]
    return transcribe_handler


class ASRWorker:
    """Pub/sub batch consumer: waits for one audio message, takes up to
    ``max_batch`` that are already pending, transcribes them in ONE
    device batch (in a worker thread, so the loop stays live), publishes
    the results, then commits."""

    def __init__(self, transcriber: Transcriber, pubsub: Any,
                 in_topic: str = "asr.requests",
                 out_topic: str = "asr.results",
                 group: str = "asr-workers",
                 drain_wait_s: float = 0.01) -> None:
        self.transcriber = transcriber
        self.pubsub = pubsub
        self.in_topic = in_topic
        self.out_topic = out_topic
        self.group = group
        self.drain_wait_s = drain_wait_s
        self.processed = 0
        self.batches = 0

    async def _drain(self, max_batch: int) -> list:
        first = await self.pubsub.subscribe(self.in_topic, self.group)
        messages = [first]
        while len(messages) < max_batch:
            try:
                more = await asyncio.wait_for(
                    self.pubsub.subscribe(self.in_topic, self.group),
                    timeout=self.drain_wait_s)
                messages.append(more)
            except asyncio.TimeoutError:
                break
        return messages

    async def run_once(self) -> int:
        """One drain -> one device batch -> publish and commit. Returns
        the number of messages transcribed."""
        messages = await self._drain(self.transcriber.asr.max_batch)
        audios, ok_msgs = [], []
        for msg in messages:
            try:
                audios.append(decode_audio_payload(msg.bind()))
                ok_msgs.append(msg)
            except Exception:  # noqa: BLE001 — any undecodable payload
                msg.commit()  # poison: drop it, never redeliver it
        if not audios:
            return 0
        results = await asyncio.to_thread(
            self.transcriber.transcribe_batch, audios)
        for msg, result in zip(ok_msgs, results):
            payload = msg.bind()
            request_id = (str(payload.get("request_id", ""))
                          if isinstance(payload, dict) else "")
            await self.pubsub.publish(self.out_topic,
                                      {"request_id": request_id, **result})
            msg.commit()  # only once the transcript is out
        self.processed += len(ok_msgs)
        self.batches += 1
        return len(ok_msgs)

    async def run(self) -> None:
        while True:
            try:
                await self.run_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the worker keeps running
                await asyncio.sleep(2.0)  # back off, then drain again


class LoopThread:
    """An asyncio event loop on a daemon thread: ``start(coro)`` runs a
    long-lived coroutine there as a task (a worker's ``run()``),
    ``call(coro)`` runs one to its end from another thread (a publish
    into a broker that lives on the loop), ``stop()`` cancels the task,
    waits for it, and ends the thread."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever,
                                        name="asr-loop", daemon=True)
        self._task: asyncio.Task | None = None

    def start(self, coro) -> None:
        self._thread.start()

        async def spawn() -> asyncio.Task:
            return asyncio.ensure_future(coro)
        self._task = self.call(spawn())

    def call(self, coro, timeout: float | None = None) -> Any:
        return asyncio.run_coroutine_threadsafe(coro, self.loop) \
            .result(timeout)

    def stop(self, timeout: float = 10.0) -> None:
        if not self._thread.is_alive():
            return
        task = self._task

        async def cancel() -> None:
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        try:
            self.call(cancel(), timeout)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout)
        if not self._thread.is_alive():
            self.loop.close()
