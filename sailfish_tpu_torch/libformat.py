"""Library-format model: read layout, orientation, strandedness.

Re-implements the semantics of the reference LibraryFormat
(include/LibraryFormat.hpp) and the compatibility predicates of
src/SailfishUtils.cpp:63-289 — including the bit-packed formatID codec
and the paired-end observed-libtype classifier (`hit_type`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ReadType(enum.IntEnum):  # include/LibraryFormat.hpp:7
    SINGLE_END = 0
    PAIRED_END = 1


class ReadOrientation(enum.IntEnum):  # include/LibraryFormat.hpp:8
    SAME = 0
    AWAY = 1
    TOWARD = 2
    NONE = 3


class ReadStrandedness(enum.IntEnum):  # include/LibraryFormat.hpp:9
    SA = 0  # mate1 sense, mate2 antisense
    AS = 1  # mate1 antisense, mate2 sense
    S = 2   # sense
    A = 3   # antisense
    U = 4   # unstranded


class MateStatus(enum.IntEnum):
    """Which end(s) of a fragment a hit represents (RapMap MateStatus)."""
    SINGLE_END = 0
    PAIRED_END_LEFT = 1
    PAIRED_END_RIGHT = 2
    PAIRED_END_PAIRED = 3


@dataclass(frozen=True)
class LibraryFormat:
    type: ReadType
    orientation: ReadOrientation
    strandedness: ReadStrandedness

    def format_id(self) -> int:
        """Unique bit-packed id (include/LibraryFormat.hpp:89-98)."""
        return (
            (int(self.type) & 0x1)
            | ((int(self.orientation) & 0x3) << 1)
            | ((int(self.strandedness) & 0x7) << 3)
        )

    @staticmethod
    def from_id(fid: int) -> "LibraryFormat":
        """Inverse of format_id (include/LibraryFormat.hpp:37-85)."""
        return LibraryFormat(
            ReadType(fid & 0x1),
            ReadOrientation((fid >> 1) & 0x3),
            ReadStrandedness((fid >> 3) & 0x7),
        )

    @property
    def name(self) -> str:
        for k, v in _FORMAT_MAP.items():
            if v == self:
                return k
        return f"fmt:{self.format_id()}"


# The 12 named formats (src/SailfishUtils.cpp:69-81).
_FORMAT_MAP = {
    "IU": LibraryFormat(ReadType.PAIRED_END, ReadOrientation.TOWARD, ReadStrandedness.U),
    "ISF": LibraryFormat(ReadType.PAIRED_END, ReadOrientation.TOWARD, ReadStrandedness.SA),
    "ISR": LibraryFormat(ReadType.PAIRED_END, ReadOrientation.TOWARD, ReadStrandedness.AS),
    "OU": LibraryFormat(ReadType.PAIRED_END, ReadOrientation.AWAY, ReadStrandedness.U),
    "OSF": LibraryFormat(ReadType.PAIRED_END, ReadOrientation.AWAY, ReadStrandedness.SA),
    "OSR": LibraryFormat(ReadType.PAIRED_END, ReadOrientation.AWAY, ReadStrandedness.AS),
    "MU": LibraryFormat(ReadType.PAIRED_END, ReadOrientation.SAME, ReadStrandedness.U),
    "MSF": LibraryFormat(ReadType.PAIRED_END, ReadOrientation.SAME, ReadStrandedness.S),
    "MSR": LibraryFormat(ReadType.PAIRED_END, ReadOrientation.SAME, ReadStrandedness.A),
    "U": LibraryFormat(ReadType.SINGLE_END, ReadOrientation.NONE, ReadStrandedness.U),
    "SF": LibraryFormat(ReadType.SINGLE_END, ReadOrientation.NONE, ReadStrandedness.S),
    "SR": LibraryFormat(ReadType.SINGLE_END, ReadOrientation.NONE, ReadStrandedness.A),
}


def parse_library_format(fmt: str) -> LibraryFormat:
    """Parse a libtype string such as 'IU' (src/SailfishUtils.cpp:63-97)."""
    key = fmt.upper()
    if key not in _FORMAT_MAP:
        raise ValueError(f"unknown library format string : {fmt}")
    return _FORMAT_MAP[key]


def all_named_formats() -> dict[str, LibraryFormat]:
    return dict(_FORMAT_MAP)


def compatible_hit_single(
    expected: LibraryFormat, is_forward: bool, mate_status: MateStatus
) -> bool:
    """Compatibility of a single-end / orphan hit with the expected libtype.

    Truth table from src/SailfishUtils.cpp:157-211.  (The `start`
    argument of the reference function is unused there.)
    """
    s = expected.strandedness
    U, S, A = ReadStrandedness.U, ReadStrandedness.S, ReadStrandedness.A
    if mate_status == MateStatus.SINGLE_END:
        if is_forward:
            return s in (U, S)
        return s in (U, A)
    if mate_status == MateStatus.PAIRED_END_LEFT:
        if expected.orientation == ReadOrientation.SAME:
            return s == U or (s == S and is_forward) or (s == A and not is_forward)
        if is_forward:
            return s in (U, S)
        return s in (U, A)
    if mate_status == MateStatus.PAIRED_END_RIGHT:
        if expected.orientation == ReadOrientation.SAME:
            return s == U or (s == S and is_forward) or (s == A and not is_forward)
        if is_forward:
            return s in (U, A)
        return s in (U, S)
    return False


def compatible_hit_paired(expected: LibraryFormat, observed: LibraryFormat) -> bool:
    """PE compatibility (src/SailfishUtils.cpp:215-239): orientations must
    match exactly; expected strandedness U accepts anything, else exact."""
    if observed.type != ReadType.PAIRED_END:
        return False
    if expected.orientation != observed.orientation:
        return False
    return (
        expected.strandedness == ReadStrandedness.U
        or expected.strandedness == observed.strandedness
    )


def hit_type(
    end1_start: int,
    end1_fwd: bool,
    len1: int,
    end2_start: int,
    end2_fwd: bool,
    len2: int,
    can_dovetail: bool = False,
) -> LibraryFormat:
    """Classify the observed libtype of a mapped pair
    (src/SailfishUtils.cpp:243-289)."""
    PE = ReadType.PAIRED_END
    if end1_fwd != end2_fwd:
        if end1_fwd:
            stretch = len2 if can_dovetail else 0
            if end1_start <= end2_start + stretch:
                return LibraryFormat(PE, ReadOrientation.TOWARD, ReadStrandedness.SA)
            return LibraryFormat(PE, ReadOrientation.AWAY, ReadStrandedness.SA)
        else:
            stretch = len1 if can_dovetail else 0
            if end2_start <= end1_start + stretch:
                return LibraryFormat(PE, ReadOrientation.TOWARD, ReadStrandedness.AS)
            return LibraryFormat(PE, ReadOrientation.AWAY, ReadStrandedness.AS)
    if end1_fwd:
        return LibraryFormat(PE, ReadOrientation.SAME, ReadStrandedness.S)
    return LibraryFormat(PE, ReadOrientation.SAME, ReadStrandedness.A)


def se_compat_flags(expected: LibraryFormat) -> tuple[bool, bool, bool, bool]:
    """Compatibility of orphan/SE hits folded to four booleans for the
    vectorized device path: (left_fwd_ok, left_rc_ok, right_fwd_ok,
    right_rc_ok) — evaluated through compatible_hit_single so the truth
    table lives in one place."""
    return (
        compatible_hit_single(expected, True, MateStatus.PAIRED_END_LEFT),
        compatible_hit_single(expected, False, MateStatus.PAIRED_END_LEFT),
        compatible_hit_single(expected, True, MateStatus.PAIRED_END_RIGHT),
        compatible_hit_single(expected, False, MateStatus.PAIRED_END_RIGHT),
    )
