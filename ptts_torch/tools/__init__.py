"""The port's measuring tools, each run as ``python -m ptts_torch.tools.<name>``:
bench_http (the HTTP front door), bench_streaming (time to first chunk and
the per-frame slope) and profile_stages (device time per pipeline stage).
ptts_torch.bench runs the whole benchmark."""
