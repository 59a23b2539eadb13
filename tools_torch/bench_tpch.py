"""TPC-H-like snowflake query simulation (reference tests/bench-tpch
analog, bench01.cpp).

Schema: nations -> suppliers / customers -> orders.  Each dimension gets
a bitmap index (nation -> customer-id bitmap, …), indexes live as
serialized BLOBs (the reference stores them the same way and merges with
operation_deserializer), and the benchmark query is a snowflake join:

  orders of customers in the top-N nations
    = expand( OR over the N serialized customer bitmaps )

with the OR applied straight against the compressed BLOBs.

Runs on the card; with BMTPU_PLATFORM=cpu on the CPU.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bitmagic_tpu_torch as bm  # noqa: E402
from bitmagic_tpu_torch import constants as C  # noqa: E402
from bitmagic_tpu_torch.serial.opdeser import (  # noqa: E402
    OperationDeserializer)
from bitmagic_tpu_torch.serial.serializer import Serializer  # noqa: E402
from tools_torch import sync  # noqa: E402

ORDERS_PER_CUSTOMER = 5


def build_indexes(rng, nations, customers, level):
    """nation id -> serialized customer-bitmap BLOB."""
    nation_of = rng.integers(0, nations, customers)
    ser = Serializer(level)
    blobs = {}
    for n in range(nations):
        ids = np.flatnonzero(nation_of == n)
        blobs[n] = ser.serialize(bm.BitVector.from_indices(ids, customers))
    return nation_of, blobs


def query_orders_of_nations(blobs, top, customers):
    """OR the serialized customer indexes of `top` nations (BLOB-level),
    then expand customers -> orders."""
    opd = OperationDeserializer()
    cust = bm.BitVector(customers)
    for n in top:
        opd.deserialize(cust, blobs[n], C.SET_OR)
    cust_ids = cust.indices()
    order_ids = (cust_ids[:, None] * ORDERS_PER_CUSTOMER
                 + np.arange(ORDERS_PER_CUSTOMER)).reshape(-1)
    return cust, bm.BitVector.from_indices(
        order_ids, customers * ORDERS_PER_CUSTOMER)


def main(argv=None):
    bm.config.device_from_env()   # BMTPU_PLATFORM=cpu: the CPU
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nations", type=int, default=200)
    p.add_argument("--customers", type=int, default=150_000)
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--level", type=int, default=6)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    rng = np.random.default_rng(9)
    t0 = time.perf_counter()
    nation_of, blobs = build_indexes(rng, args.nations, args.customers,
                                     args.level)
    t_build = time.perf_counter() - t0
    idx_bytes = sum(len(b) for b in blobs.values())

    top = list(range(args.top))
    sync()
    t0 = time.perf_counter()
    cust, orders = query_orders_of_nations(blobs, top, args.customers)
    sync()
    t_query = time.perf_counter() - t0

    want = int(np.isin(nation_of, top).sum())
    if cust.count() != want or \
            orders.count() != want * ORDERS_PER_CUSTOMER:
        raise RuntimeError(f"bench_tpch: {cust.count()} customers and "
                           f"{orders.count()} orders, numpy has {want} "
                           f"customers")

    if args.json:
        print(json.dumps({
            "customers": args.customers, "nations": args.nations,
            "index_bytes": idx_bytes, "build_s": round(t_build, 3),
            "query_s": round(t_query, 3),
            "result_orders": int(orders.count())}))
    else:
        print(f"{args.nations} nation indexes over {args.customers} "
              f"customers: {idx_bytes} bytes serialized, "
              f"built in {t_build:.2f}s")
        print(f"snowflake query (top {args.top} nations): "
              f"{orders.count()} orders in {t_query * 1000:.1f} ms "
              f"(BLOB-level OR, no index decompression step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
