"""In-memory frame round trip, the examples/simple_buffer.c analog, on
the one-shot `compress` / `decompress` of the default backend (the GPU
unless `backend` names another).

    python -m lz4_tpu_torch.examples.simple_buffer
"""
import lz4_tpu_torch


def main(backend=None):
    src = (b"Lorem ipsum dolor sit amet, consectetur adipiscing elit. " * 50)
    comp = lz4_tpu_torch.compress(src, store_content_size=True,
                                  backend=backend)
    print(f"compressed {len(src)} -> {len(comp)} bytes "
          f"({100.0 * len(comp) / len(src):.1f}%)")
    back = lz4_tpu_torch.decompress(comp, backend=backend)
    assert back == src
    print("round trip OK")


if __name__ == "__main__":
    main()
