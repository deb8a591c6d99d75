"""A serving replica of the port, run by the launcher's serving role
(``paddle_tpu_torch.distributed.launch --serving_script=<this>``).

It loads the inference model saved in ``PS_SERVING_MODEL`` through the
real path (``AnalysisConfig`` -> ``create_paddle_predictor``), on the card
unless ``PS_SERVING_DEVICE=cpu``, serves it with a ``ServingEngine``
behind its HTTP front on ``PADDLE_SERVING_ENDPOINT``, and serves until the
launcher stops it (SIGTERM, once every trainer has exited).
"""
import os
import signal
import threading


def main():
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)

    cfg = AnalysisConfig(os.environ["PS_SERVING_MODEL"])
    if os.environ.get("PS_SERVING_DEVICE") == "cpu":
        cfg.disable_gpu()
    engine = serving.ServingEngine(
        create_paddle_predictor(cfg),
        serving.ServingConfig(max_batch_size=int(os.environ.get(
            "PS_SERVING_MAX_BATCH", "8"))))
    engine.start()
    host, port = os.environ["PADDLE_SERVING_ENDPOINT"].rsplit(":", 1)
    server, _ = serving.start_http_server(engine, host, int(port))
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    server.shutdown()
    server.server_close()
    engine.stop()


if __name__ == "__main__":
    main()
