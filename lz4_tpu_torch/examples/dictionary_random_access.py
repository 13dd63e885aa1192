"""Dictionary-based random access — the
examples/dictionaryRandomAccess.c analog: compress N records against a
shared dictionary, then decode any single record without its
neighbours.

    python -m lz4_tpu_torch.examples.dictionary_random_access
"""
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.utils.datagen import gen_buffer


def main():
    be = HostBackend()
    dictionary = gen_buffer(16 * 1024, match_prob=0.6, seed=42)
    records = [dictionary[:4000] + gen_buffer(2000, seed=i)
               for i in range(10)]
    comp = be.compress_batch(records,
                             dict_prefixes=[dictionary] * len(records))
    # random access: decode record 7 alone
    rec7 = be.decompress_batch([comp[7]], [len(records[7])],
                               dict_prefixes=[dictionary])[0]
    assert rec7 == records[7]
    plain = be.compress_batch(records)
    print(f"10 records: {sum(map(len, comp))} bytes with dict vs "
          f"{sum(map(len, plain))} without; random access verified")


if __name__ == "__main__":
    main()
