"""CER accounting with confusion counters and boundary-error
classification (port of pero_ocr_tpu/error_summary.py)."""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from enum import Enum
from typing import Iterable, List

from pero_ocr_tpu_torch.sequence_alignment import (
    edit_stats_for_alignment,
    levenshtein_alignment,
    levenshtein_distance,
)

MatchTypes = Enum("MatchTypes", "C S I D")


def get_match_type(ref_sym, hyp_sym) -> MatchTypes:
    if ref_sym is None and hyp_sym is None:
        raise AssertionError("Invalid alignment None-None")
    if ref_sym == hyp_sym:
        return MatchTypes.C
    if ref_sym is None:
        return MatchTypes.I
    if hyp_sym is None:
        return MatchTypes.D
    return MatchTypes.S


def get_non_matching_prefix(alignment_types) -> List[MatchTypes]:
    prefix = []
    for t in alignment_types:
        if t == MatchTypes.C:
            break
        prefix.append(t)
    return prefix


def get_non_matching_suffix(alignment_types) -> List[MatchTypes]:
    return list(reversed(get_non_matching_prefix(reversed(alignment_types))))


class BoundaryErrorsSummary:
    """Classify the error run at a line's end into pure/mixed
    insertion/deletion/substitution classes."""

    def __init__(self, boundary_alignment):
        if (
            MatchTypes.I in boundary_alignment
            and MatchTypes.D in boundary_alignment
        ):
            raise AssertionError(
                "Got both insertion and deletion in the ending errors."
            )
        has_s = MatchTypes.S in boundary_alignment
        has_d = MatchTypes.D in boundary_alignment
        has_i = MatchTypes.I in boundary_alignment

        self.correct = len(boundary_alignment) == 0
        self.mixed_deletions = has_s and has_d
        self.mixed_insertions = has_s and has_i
        self.pure_deletions = has_d and not has_s
        self.pure_insertions = has_i and not has_s
        self.pure_substitutions = has_s and not has_d and not has_i

    def __eq__(self, other):
        return (
            self.pure_deletions == other.pure_deletions
            and self.mixed_deletions == other.mixed_deletions
        )

    def __iadd__(self, other):
        self.pure_deletions += other.pure_deletions
        self.mixed_deletions += other.mixed_deletions
        self.pure_insertions += other.pure_insertions
        self.mixed_insertions += other.mixed_insertions
        self.pure_substitutions += other.pure_substitutions
        self.correct += other.correct
        return self

    @staticmethod
    def empty_summary() -> "BoundaryErrorsSummary":
        summary = BoundaryErrorsSummary.__new__(BoundaryErrorsSummary)
        summary.correct = 0
        summary.pure_deletions = 0
        summary.mixed_deletions = 0
        summary.pure_insertions = 0
        summary.mixed_insertions = 0
        summary.pure_substitutions = 0
        return summary


class ErrorsSummary:
    def __init__(
        self,
        nb_lines_summarized,
        ref_len,
        nb_errors,
        nb_subs,
        nb_inss,
        nb_dels,
        confusions,
        ending_errors,
    ):
        self.nb_lines_summarized = nb_lines_summarized
        self.nb_errors = nb_errors
        self.nb_subs = nb_subs
        self.nb_inss = nb_inss
        self.nb_dels = nb_dels
        self.ref_len = ref_len
        self.confusions = confusions
        self.ending_errors = ending_errors
        self.error_rate = (
            nb_errors / ref_len if ref_len > 0 else math.inf
        )

    @classmethod
    def from_lists(cls, ref, hyp) -> "ErrorsSummary":
        ref_len = len(ref)
        nb_errors = levenshtein_distance(ref, hyp)
        alignment = levenshtein_alignment(hyp, ref)
        _, _, nb_inss, nb_dels, nb_subs = edit_stats_for_alignment(alignment)

        confusions = defaultdict(Counter)
        for hyp_sym, ref_sym in alignment:
            confusions[ref_sym][hyp_sym] += 1

        match_types = [get_match_type(r, h) for h, r in alignment]
        ending = BoundaryErrorsSummary(get_non_matching_suffix(match_types))
        return cls(
            1, ref_len, nb_errors, nb_subs, nb_inss, nb_dels, confusions, ending
        )

    @staticmethod
    def aggregate(errors: Iterable["ErrorsSummary"]) -> "ErrorsSummary":
        total_lines = total_ref = total_err = 0
        total_subs = total_ins = total_del = 0
        total_boundary = BoundaryErrorsSummary.empty_summary()
        total_confusions = defaultdict(Counter)
        for err in errors:
            total_lines += err.nb_lines_summarized
            total_ref += err.ref_len
            total_err += err.nb_errors
            total_subs += err.nb_subs
            total_ins += err.nb_inss
            total_del += err.nb_dels
            for k in err.confusions:
                total_confusions[k].update(err.confusions[k])
            total_boundary += err.ending_errors
        return ErrorsSummary(
            total_lines, total_ref, total_err, total_subs, total_ins,
            total_del, total_confusions, total_boundary,
        )

    def __str__(self):
        return (
            f"{100.0 * self.error_rate:.2f} % ( {self.nb_errors} / "
            f"{self.ref_len} ; sub: {self.nb_subs} ins: {self.nb_inss} "
            f"del: {self.nb_dels} )"
        )
