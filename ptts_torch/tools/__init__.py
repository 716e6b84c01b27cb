"""The port's tools, each a port of its namesake in tools/ and run as
``python -m ptts_torch.tools.<name>``. On the card by default; with no card
visible each prints no result and exits non-zero, except where the CPU is
asked for.

  bench_http          the HTTP front door (http_* keys)
  bench_streaming     time to first chunk and the per-frame slope
  profile_stages      device time per pipeline stage
  bench_batcher_sweep the batcher bench over slots x K x serial/pipelined
  bench_batch_sweep   the offline bench over batch sizes
  sanitize            guarded kernel launches, the per-operation NaN trap,
                      the PTTS_SANITIZE guards and a planted NaN weight;
                      ``--device cpu --tiny`` runs phases 2-4 on the CPU
  flowlm_parity       the --flow-test taps against the reference binary,
                      upstream pocket_tts or dumps (--other-dumps
                      tests/data/jax_golden: the JAX package's full-width
                      dumps, read by chip_smoke.py phase 14); --device cpu
  hello_world_test    the golden "Hello world!" gates (exit 77 without the
                      real weights and the golden WAV); --device cpu

ptts_torch.bench runs the whole benchmark."""
