"""Serialization support of the port.  So far only the native codec library
(``serial/native``), whose block decoders the BitVector's ``indices()``,
its enumerators and ``algo.intervals`` call."""
