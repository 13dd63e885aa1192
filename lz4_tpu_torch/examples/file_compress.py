"""File compression through the lz4file-style wrappers, the
examples/fileCompress.c analog, on the default backend (the GPU unless
`backend` names another).

    python -m lz4_tpu_torch.examples.file_compress FILE
"""
import os
import sys

from lz4_tpu_torch.frame.file import open_frame


def main(path, backend=None):
    with open(path, "rb") as fin, \
            open_frame(path + ".lz4", "wb", backend=backend) as fout:
        while True:
            chunk = fin.read(1 << 20)
            if not chunk:
                break
            fout.write(chunk)
    with open_frame(path + ".lz4", "rb", backend=backend) as fin:
        data = fin.read()
    with open(path, "rb") as f:
        assert data == f.read()
    print(f"{path}: {os.path.getsize(path)} -> "
          f"{os.path.getsize(path + '.lz4')} bytes, verified")


if __name__ == "__main__":
    main(sys.argv[1])
