"""A transfer function's evaluation at one value: a binary search over
its P points (ceil(log2 P) compares), the segment's parameter (a subtract
and a multiply) and one lerp (two operations) a channel."""

import math


def search_ops(points: int) -> int:
    return max(1, math.ceil(math.log2(max(points, 2))))


def eval_ops(points: int, channels: int) -> int:
    return search_ops(points) + 2 + 2 * channels
