"""HTTP serving front-end of the port (continuous batching), standard
library only. The port's counterpart of the repository's ``serve.py``.

  POST /generate   {"prompt": [token ids], "max_tokens": 128,
                    "temperature": 0.0, "top_k": 0, "top_p": 1.0,
                    "ignore_eos": false, "stop_token_ids": [],
                    "blocking": true, "stream": false}
                   -> {"request_id", "token_ids", "num_tokens", "mat"}
                   (blocks until that request finishes; other requests
                   keep decoding in the same batch). With "blocking":
                   false -> {"request_id"} at admission; collect it with
                   /result. With "stream": true the reply is
                   newline-delimited JSON: {"request_id"}, then
                   {"token_ids": [...], "done": false} chunks as tokens
                   verify (only the rollback-proof prefix,
                   PearlEngine.serve_step with_deltas), then a final
                   {"done": true, ...} record with the result fields.
  GET  /result?request_id=N -> blocks until that request finishes
  POST /cancel     {"request_id": N} -> {"cancelled": bool}
  GET  /health     -> {"ok": true, "queued": N, **engine.stats()}

Prompts are token ids: the port has no tokenizer. Every engine call
runs on ONE driver thread, so CUDA work is only ever launched from it;
HTTP handler threads enqueue work and wait on per-request events.
Requests submitted while a batch runs join it at the next serve_step in
pre-verify state, without draining it.

    python -m nano_pearl_tpu_torch.serve --layer-share          # on the GPU
    python -m nano_pearl_tpu_torch.serve --layer-share --cpu    # plain versions, f32
    python -m nano_pearl_tpu_torch.serve -d DRAFT_DIR -t TARGET_DIR   # HF checkpoints
    python -m nano_pearl_tpu_torch.serve --layer-share --draft-tp 2 --target-tp 2  # tensor parallel

Without ``--cpu`` the engine needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from nano_pearl_tpu_torch.config import ModelConfig, PearlConfig, SamplingParams
from nano_pearl_tpu_torch.utils.logging import logger


class PearlServer:
    """Driver thread: owns the engine, admits queued requests, steps the
    continuous-batching loop and resolves waiters on completion."""

    def __init__(self, engine, fused_rounds: int = 8, idle_sleep: float = 0.005):
        self.engine = engine
        self.fused_rounds = fused_rounds
        self.idle_sleep = idle_sleep
        self.inbox: queue.Queue = queue.Queue()
        self.cancel_box: queue.Queue = queue.Queue()
        self.results: dict[int, dict] = {}
        self.events: dict[int, threading.Event] = {}
        # per-request streaming subscriptions, seq_id -> Queue of
        # (token_ids, finished), registered by the driver at admission so
        # that no delta exists before its queue does
        self.streams: dict[int, queue.Queue] = {}
        self.lock = threading.Lock()
        self.queued = 0
        self.error: str | None = None  # set if the driver thread died
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit_async(self, prompt, params, timeout: float = 60.0,
                     stream_q: queue.Queue | None = None) -> int:
        """Thread-safe: enqueue a request; returns its id once admitted."""
        admitted = threading.Event()
        done = threading.Event()
        self.inbox.put((prompt, params, done, admitted, stream_q))
        with self.lock:
            self.queued += 1
        if not admitted.wait(timeout):
            raise TimeoutError("admission timed out")
        if getattr(done, "error", None):
            raise ValueError(done.error)
        return done.seq_id

    def submit_stream(self, prompt, params, timeout: float = 60.0):
        """Thread-safe: enqueue a streaming request; returns (request_id,
        queue of (token_ids, finished) chunks)."""
        q: queue.Queue = queue.Queue()
        return self.submit_async(prompt, params, timeout, stream_q=q), q

    def result(self, request_id: int, timeout: float | None = None) -> dict:
        """Block until the request finishes or is cancelled."""
        ev = self.events.get(request_id)
        if ev is None:
            if request_id in self.results:
                return self.results.pop(request_id)
            raise KeyError(f"unknown request {request_id}")
        if not ev.wait(timeout):
            raise TimeoutError("generation timed out")
        return self.results.pop(request_id)

    def generate(self, prompt, params, timeout: float | None = None) -> dict:
        """Thread-safe: enqueue a request and block until it finishes."""
        return self.result(self.submit_async(prompt, params), timeout)

    def cancel(self, request_id: int, timeout: float = 30.0) -> bool:
        """Thread-safe: ask the driver thread to abort a request."""
        done = threading.Event()
        self.cancel_box.put((request_id, done))
        done.wait(timeout)
        return bool(getattr(done, "cancelled", False))

    def stats(self) -> dict:
        with self.lock:
            out = {"ok": self.error is None, "queued": self.queued}
        out.update(self.engine.stats())  # a snapshot; a read-only race is harmless
        return out

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=30)

    # ------------------------------------------------------ driver thread

    def _admit(self):
        while True:
            try:
                prompt, params, done, admitted, stream_q = self.inbox.get_nowait()
            except queue.Empty:
                return
            try:
                seq_id = self.engine.submit(prompt, params)
            except (ValueError, TypeError, NotImplementedError) as e:
                # a bad request must not stop the driver
                done.seq_id = -1
                done.error = f"{type(e).__name__}: {e}"
                admitted.set()
                done.set()
                with self.lock:
                    self.queued -= 1
                continue
            done.seq_id = seq_id  # routes the result back to this waiter
            self.events[seq_id] = done
            if stream_q is not None:
                self.streams[seq_id] = stream_q
            admitted.set()
            with self.lock:
                self.queued -= 1

    def _drain_cancels(self):
        while True:
            try:
                request_id, done = self.cancel_box.get_nowait()
            except queue.Empty:
                return
            done.cancelled = self.engine.cancel(request_id)
            if done.cancelled:
                waiter = self.events.pop(request_id, None)
                if waiter is not None:
                    self.results[request_id] = {"request_id": request_id, "cancelled": True}
                    waiter.set()
                sub = self.streams.pop(request_id, None)
                if sub is not None:
                    sub.put(([], True))  # unblocks the streaming reader
            done.set()

    def _step(self):
        done, deltas = self.engine.serve_step(self.fused_rounds, with_deltas=True)
        for seq_id, token_ids, num_acc in done:
            result = {
                "request_id": seq_id,
                "token_ids": token_ids,
                "num_tokens": len(token_ids),
                "mat": round(sum(num_acc) / max(1, len(num_acc)), 2),
            }
            event = self.events.pop(seq_id, None)
            if event is not None:
                self.results[seq_id] = result
                event.set()
        for seq_id, token_ids, finished in deltas:
            sub = self.streams.get(seq_id)
            if sub is not None:
                sub.put((token_ids, finished))
                if finished:
                    del self.streams[seq_id]

    def _run(self):
        try:
            while not self._stop.is_set():
                self._admit()
                self._drain_cancels()
                if not self.engine.has_work:
                    time.sleep(self.idle_sleep)
                    continue
                self._step()
        except Exception as e:  # the engine failed: report it on /health and to waiters
            logger.error(f"serving driver stopped: {type(e).__name__}: {e}")
            with self.lock:
                self.error = f"{type(e).__name__}: {e}"
            for rid, ev in list(self.events.items()):
                self.results[rid] = {"request_id": rid, "error": self.error}
                ev.set()
            for sub in list(self.streams.values()):
                sub.put(([], True))
            raise


def make_handler(server: PearlServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path == "/health":
                return self._reply(200, server.stats())
            if self.path.startswith("/result"):
                try:
                    rid = int(parse_qs(urlparse(self.path).query)["request_id"][0])
                    return self._reply(200, server.result(rid, timeout=600))
                except KeyError:
                    return self._reply(404, {"error": "unknown request_id"})
                except (ValueError, TimeoutError) as e:
                    return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            return self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/cancel":
                try:
                    return self._reply(200, {"cancelled": server.cancel(int(self._body()["request_id"]))})
                except (KeyError, ValueError, TypeError) as e:
                    return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
            try:
                req = self._body()
                params = SamplingParams(
                    temperature=float(req.get("temperature", 0.0)),
                    max_tokens=int(req.get("max_tokens", 128)),
                    ignore_eos=bool(req.get("ignore_eos", False)),
                    top_k=int(req.get("top_k", 0)),
                    top_p=float(req.get("top_p", 1.0)),
                    stop_token_ids=tuple(int(t) for t in req.get("stop_token_ids", ())),
                )
                prompt = [int(t) for t in req["prompt"]]
                if req.get("stream", False):
                    return self._stream(prompt, params)
                if req.get("blocking", True):
                    return self._reply(200, server.generate(prompt, params))
                return self._reply(200, {"request_id": server.submit_async(prompt, params)})
            except (KeyError, ValueError, TypeError, TimeoutError) as e:
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def _stream(self, prompt, params):
            """Newline-delimited JSON: token chunks as they verify, then a
            final record with the result fields. Submission errors raise
            before the headers go out (do_POST answers 400); after the 200
            status line this never raises: a dead client or a stalled
            generation cancels the request instead."""
            rid, q = server.submit_stream(prompt, params)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()  # no Content-Length: closing the connection ends the body

            def line(payload):
                self.wfile.write((json.dumps(payload) + "\n").encode())
                self.wfile.flush()

            try:
                line({"request_id": rid})
                while True:
                    token_ids, finished = q.get(timeout=600)
                    if token_ids:  # the finishing chunk may carry the last tokens
                        line({"token_ids": token_ids, "done": False})
                    if finished:
                        break
                final = {"request_id": rid, "done": True}
                try:
                    final.update(server.result(rid, timeout=10))
                except KeyError:
                    final["cancelled"] = True  # cancelled before it finished
                line(final)
            except (OSError, queue.Empty, TimeoutError):
                # client gone or generation stalled: stop decoding for it
                server.cancel(rid)

    return Handler


def layer_share_models(args) -> tuple[ModelConfig, ModelConfig]:
    """The weightless serving pair: hidden 1024, ffn 4096, 16 query heads
    of 64, 2 KV heads, vocab 32768; f32 on the CPU, bf16 on the card."""
    def mc(layers):
        return ModelConfig(
            architecture="LlamaForCausalLM", hidden_size=1024, intermediate_size=4096,
            num_hidden_layers=layers, num_attention_heads=16, num_key_value_heads=2,
            vocab_size=32768, eos_token_id=1, dtype="float32" if args.cpu else "bfloat16",
            max_position_embeddings=max(2048, args.max_model_len),
        )

    return mc(args.draft_layers), mc(args.target_layers)


def build_engine(args, **config):
    """The engine ``args`` ask for, on the CUDA device unless ``--cpu`` (f32
    there): the layer-share pair with random weights from ``--seed``
    (``--layer-share``, the ceiling profile), or the HF checkpoint
    directories ``--draft-model`` / ``--target-model``, loaded by the engine,
    under the throughput profile, as the repository's ``serve.py`` picks it
    for real pairs. ``config`` sets further ``PearlConfig`` fields (the
    command line keeps their defaults)."""
    from nano_pearl_tpu_torch.engine.engine import PearlEngine
    from nano_pearl_tpu_torch.utils.layer_share import build_layer_share_pair

    dparams = tparams = None
    if args.layer_share:
        draft, target = layer_share_models(args)
        dparams, tparams = build_layer_share_pair(draft, target, args.seed)
    elif args.draft_model and args.target_model:
        draft, target = (ModelConfig.from_json(p) for p in (args.draft_model, args.target_model))
        if args.cpu:
            draft, target = (dataclasses.replace(m, dtype="float32") for m in (draft, target))
    else:
        raise ValueError("--draft-model/--target-model required without --layer-share")
    cfg = PearlConfig(
        draft_model=draft, target_model=target, draft_tp=args.draft_tp, target_tp=args.target_tp,
        max_model_len=args.max_model_len, gamma=args.gamma, seed=args.seed,
        perf_profile="ceiling" if args.layer_share else "throughput", dtype=draft.dtype, **config,
    )
    return PearlEngine(cfg, dparams, tparams, device="cpu" if args.cpu else None)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="nano-PEARL HTTP server (PyTorch port)")
    p.add_argument("--draft-model", "-d", default=None, help="HF checkpoint directory of the draft")
    p.add_argument("--target-model", "-t", default=None, help="HF checkpoint directory of the target")
    p.add_argument("--layer-share", action="store_true",
                   help="serve the weightless layer-share pair (random weights)")
    p.add_argument("--draft-layers", type=int, default=3)
    p.add_argument("--target-layers", type=int, default=36)
    p.add_argument("--draft-tp", type=int, default=1,
                   help="tensor-parallel ranks of the draft (placed with the target's on the devices)")
    p.add_argument("--target-tp", type=int, default=1, help="tensor-parallel ranks of the target")
    p.add_argument("--max-model-len", type=int, default=4096)
    p.add_argument("--gamma", type=int, default=8)
    p.add_argument("--fused-rounds", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU, in f32")
    p.add_argument("--warmup-batches", default="1,8,32",
                   help="comma-separated batch sizes to drive through serve rounds "
                   "before accepting traffic; empty to skip")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(args)
    if args.warmup_batches:
        engine.warmup(batches=tuple(int(b) for b in args.warmup_batches.split(",")))
    server = PearlServer(engine, fused_rounds=args.fused_rounds)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    print(f"serving on http://{args.host}:{args.port}  (POST /generate, GET /health)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()


if __name__ == "__main__":
    main()
