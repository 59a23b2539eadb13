"""Serialization of bit-vectors (port of ``bitmagic_tpu/serial``): the BMT1
format (``serializer``), the operation deserializer and the stream
iterator that apply set ops straight against a BLOB, the reference's own
BLOB format (``refcodec``), XOR-delta groups (``xor_group``) and the
native codec library (``native``) whose C hot loops all of them use."""

from . import encoding, native, ref_sv, refcodec
from .opdeser import OperationDeserializer
from .refcodec import (RefDeserializer, RefSerializer, ref_deserialize,
                       ref_serialize)
from .serializer import Deserializer, Serializer, deserialize, serialize
from .stream_iter import IteratorDeserializer, SerialStreamIterator
from .sv_serial import (SparseVectorDeserializer, SparseVectorSerializer,
                        sparse_vector_deserialize, sparse_vector_serialize)
from .ref_sv import (deserialize_rsc_blob, deserialize_sv_blob,
                     serialize_rsc_blob, serialize_sv_blob)
from .xor_group import deserialize_group, serialize_group

__all__ = [
    "Serializer", "Deserializer", "serialize", "deserialize",
    "OperationDeserializer", "SerialStreamIterator", "IteratorDeserializer",
    "SparseVectorSerializer", "SparseVectorDeserializer",
    "sparse_vector_serialize", "sparse_vector_deserialize",
    "encoding", "native",
    "RefSerializer", "RefDeserializer", "ref_serialize", "ref_deserialize",
    "serialize_group", "deserialize_group",
    "serialize_sv_blob", "deserialize_sv_blob",
    "serialize_rsc_blob", "deserialize_rsc_blob",
    "refcodec", "ref_sv",
]
