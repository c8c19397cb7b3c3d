"""Typed error codes mirroring the reference's public error enum.

Copy of zstd_tpu/errors.py. Parity target: zstd's lib/zstd_errors.h:65-100. Each error a caller
of the reference library could observe has a counterpart here so the CLI and
API surface can report identical conditions.
"""

from __future__ import annotations

import enum


class ZstdErrorCode(enum.IntEnum):
    no_error = 0
    GENERIC = 1
    prefix_unknown = 10
    version_unsupported = 12
    frameParameter_unsupported = 14
    frameParameter_windowTooLarge = 16
    corruption_detected = 20
    checksum_wrong = 22
    literals_headerWrong = 24
    dictionary_corrupted = 30
    dictionary_wrong = 32
    dictionaryCreation_failed = 34
    parameter_unsupported = 40
    parameter_combination_unsupported = 41
    parameter_outOfBound = 42
    tableLog_tooLarge = 44
    maxSymbolValue_tooLarge = 46
    maxSymbolValue_tooSmall = 48
    cannotProduce_uncompressedBlock = 49
    stabilityCondition_notRespected = 50
    stage_wrong = 60
    init_missing = 62
    memory_allocation = 64
    workSpace_tooSmall = 66
    dstSize_tooSmall = 70
    srcSize_wrong = 72
    dstBuffer_null = 74
    noForwardProgress_destFull = 80
    noForwardProgress_inputEmpty = 82


class ZstdError(Exception):
    """Exception carrying a ZstdErrorCode, raised across the framework."""

    def __init__(self, code: ZstdErrorCode, msg: str = ""):
        self.code = code
        super().__init__(f"{code.name}: {msg}" if msg else code.name)


def err(code: ZstdErrorCode, msg: str = "") -> ZstdError:
    return ZstdError(code, msg)


class Corruption(ZstdError):
    def __init__(self, msg: str = ""):
        super().__init__(ZstdErrorCode.corruption_detected, msg)
