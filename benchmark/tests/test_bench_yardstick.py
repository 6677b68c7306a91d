"""The frozen arithmetic: byte and operation counts by hand at one shape."""

import pytest

from benchmark import yardstick as ys


def test_k1_counts_by_hand():
    # 13 channels, 1,000 lanes onto 13 x 10 x 20, float64: per lane 2
    # positions + 13 values, the stack read and written
    nbytes, flops = ys.k1_counts(13, 1000, 10, 20, 8)
    assert nbytes == 8 * (15 * 1000 + 2 * 13 * 200)
    assert flops == 2 * 9 * 13 * 1000
    assert ys.k1_counts(2, 1000, 10, 20, 4, live=10)[1] == 2 * 9 * 2 * 10


def test_k3_counts_by_hand():
    assert ys.mg_level_shapes(2047, 2047) == [
        (n, n) for n in (2047, 1023, 511, 255, 127, 63, 31, 15, 7, 3)]
    assert ys.mg_level_shapes(15, 31) == [(31, 15), (15, 7), (7, 3)]
    nbytes, flops = ys.k3_counts(2, 15, 31, 3, 8)
    cells = 31 * 15 + 15 * 7 + 7 * 3
    assert nbytes == 8 * 7 * 31 * 15
    assert flops == 3 * 2 * cells * 42


def test_bound_is_the_larger_time():
    assert ys.bound_s(3.35e12, 0, 8) == pytest.approx(1.0)
    assert ys.bound_s(0, 34e12, 8) == pytest.approx(1.0)
    assert ys.bound_s(3.35e9, 34e12, 8) == pytest.approx(1.0)


def test_groups_first_match_wins():
    assert ys.group_of("void hipace::deposit_kernel<double>(...)") \
        == "K1 deposit"
    assert ys.group_of("void hipace::mg_solve_kernel<double, false, false, "
                       "1024>(...)") == "K3 multigrid"
    assert ys.group_of("void at::native::vectorized_elementwise_kernel<4>"
                       ) == "elementwise"
    assert ys.group_of("Memcpy DtoH (Device -> Pinned)") \
        == "cat / copy / memcpy / memset"
    assert ys.group_of("something else") == "other"


def test_push_counts():
    c = ys.push_counts(31, 31, 1, 2000, 10, 16, 2)
    assert c == {"plasma_pushes": 31 * 31 * 16, "beam_pushes": 40000,
                 "cells": 31 * 31 * 16}
