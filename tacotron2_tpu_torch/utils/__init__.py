"""Small shared helpers."""


def log(msg: str) -> None:
    print(f"[tacotron2_tpu_torch] {msg}", flush=True)
