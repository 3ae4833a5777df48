from .marshal import (  # noqa: F401
    CQLType, parse_type, TYPE_REGISTRY,
    AsciiType, TextType, BlobType, BooleanType, TinyIntType, SmallIntType,
    Int32Type, LongType, CounterColumnType, FloatType, DoubleType,
    DecimalType, IntegerType, TimestampType, SimpleDateType, TimeType,
    UUIDType, TimeUUIDType, InetAddressType, DurationType, EmptyType,
    ListType, SetType, MapType, TupleType, UserType, VectorType,
)
