"""Helpers shared by the recipes; copy of
`tokenizers_tpu.implementations.util`."""

from ..normalizers import NFC, NFD, NFKC, NFKD


def unicode_normalizer_from_str(normalizer: str):
    mapping = {"nfc": NFC, "nfd": NFD, "nfkc": NFKC, "nfkd": NFKD}
    if normalizer not in mapping:
        raise ValueError(f"{normalizer} is not a known unicode normalizer. "
                         f"Available are {list(mapping)}")
    return mapping[normalizer]()
