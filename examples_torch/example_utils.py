"""Shared fixtures for the examples (reference `examples/ExampleUtils.scala`
and `examples/entities.scala`): the port's own copy, building
``deequ_tpu_torch.Dataset``."""

from dataclasses import dataclass
from typing import Optional

import pyarrow as pa

from deequ_tpu_torch import Dataset


@dataclass
class Item:
    id: int
    product_name: Optional[str]
    description: Optional[str]
    priority: Optional[str]
    num_views: int


@dataclass
class Manufacturer:
    id: int
    manufacturer_name: Optional[str]
    country_code: str


@dataclass
class RawData:
    """Raw, mostly-string records, e.g. from a csv file (reference
    `examples/DataProfilingExample.scala` RawData)."""

    product_name: str
    total_number: Optional[str]
    status: str
    valuable: Optional[str]


def items_as_dataset(*items: Item) -> Dataset:
    # explicit types, like the reference's typed Item case class: an
    # all-null partition must still be a STRING column, not a null column
    return Dataset.from_arrow(
        pa.table(
            {
                "id": pa.array([i.id for i in items], type=pa.int64()),
                "productName": pa.array([i.product_name for i in items], type=pa.string()),
                "description": pa.array([i.description for i in items], type=pa.string()),
                "priority": pa.array([i.priority for i in items], type=pa.string()),
                "numViews": pa.array([i.num_views for i in items], type=pa.int64()),
            }
        )
    )


def manufacturers_as_dataset(*manufacturers: Manufacturer) -> Dataset:
    return Dataset.from_arrow(
        pa.table(
            {
                "id": pa.array([m.id for m in manufacturers], type=pa.int64()),
                "manufacturerName": pa.array(
                    [m.manufacturer_name for m in manufacturers], type=pa.string()
                ),
                "countryCode": pa.array(
                    [m.country_code for m in manufacturers], type=pa.string()
                ),
            }
        )
    )


def raw_data_as_dataset(*rows: RawData) -> Dataset:
    return Dataset.from_arrow(
        pa.table(
            {
                "productName": pa.array([r.product_name for r in rows], type=pa.string()),
                "totalNumber": pa.array([r.total_number for r in rows], type=pa.string()),
                "status": pa.array([r.status for r in rows], type=pa.string()),
                "valuable": pa.array([r.valuable for r in rows], type=pa.string()),
            }
        )
    )


SAMPLE_ITEMS = (
    Item(1, "Thingy A", "awesome thing.", "high", 0),
    Item(2, "Thingy B", "available at http://thingb.com", None, 0),
    Item(3, None, None, "low", 5),
    Item(4, "Thingy D", "checkout https://thingd.ca", "low", 10),
    Item(5, "Thingy E", None, "high", 12),
)

SAMPLE_RAW_DATA = (
    RawData("thingA", "13.0", "IN_TRANSIT", "true"),
    RawData("thingA", "5", "DELAYED", "false"),
    RawData("thingB", None, "DELAYED", None),
    RawData("thingC", None, "IN_TRANSIT", "false"),
    RawData("thingD", "1.0", "DELAYED", "true"),
    RawData("thingC", "7.0", "UNKNOWN", None),
    RawData("thingC", "20", "UNKNOWN", None),
    RawData("thingE", "20", "DELAYED", "false"),
)
