"""TPC-DS generator connector (subset): deterministic in-memory data.

Reference parity: plugin/trino-tpcds (TpcdsMetadata.java,
TpcdsRecordSetProvider.java) — the reference wraps the teradata dsdgen port;
here a seeded NumPy generator produces the 16 tables the decision-support
benchmark ladder needs (q64/q72 and the common store_sales family), with
spec-shaped schemas, consistent foreign keys, and the fixed date_dim
calendar. Exact dsdgen bitstreams are not load-bearing: correctness is
asserted engine-vs-oracle on the SAME generated rows (the H2QueryRunner
pattern, as with the tpch connector).

Layout conventions match connector/tpch.py: varchars dictionary-encoded,
dates as int32 days since epoch, decimals as scaled int64.

Port of `trino_tpu/connector/tpcds.py`, host NumPy as there, bit-identical
tables and statistics. Pages are staged from NumPy onto the connector's
device (pinned copies for CUDA) and kept in the TPC-H connector's staged-
column LRU (`tpch.device_cached`), so a warm scan re-stages nothing; the
host chunks share its host LRU (`tpch._host_cached`).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.connector import tpch
from trino_tpu_torch.connector import tpch_gen as _HG
from trino_tpu_torch.connector.spi import (
    ColumnHandle, ColumnMetadata, Connector, ConnectorMetadata,
    ConnectorPageSource, ConnectorSplitManager, ConnectorTableHandle,
    ColumnStatistics, SchemaTableName, Split, TableMetadata, TableStatistics,
    pad_to_capacity, split_range)
from trino_tpu_torch.expr.functions import days_from_civil
from trino_tpu_torch.page import Column, Dictionary, Page, row_count

_D7_2 = T.DecimalType(7, 2)

SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0}

# date_dim is the fixed TPC-DS calendar: 1900-01-02 .. 2100-01-01,
# d_date_sk = Julian day number starting at 2415022
_DATE_ROWS = 73049
_JULIAN_BASE = 2415022
_EPOCH_OFFSET = days_from_civil(1900, 1, 2)   # d_date of sk _JULIAN_BASE

# table -> (columns, base row count at sf1; None = fixed/derived)
_D5_2 = T.DecimalType(5, 2)

TABLES: Dict[str, tuple] = {
    "date_dim": ((
        ("d_date_sk", T.BIGINT), ("d_date_id", T.VarcharType(16)),
        ("d_date", T.DATE), ("d_month_seq", T.BIGINT),
        ("d_week_seq", T.BIGINT), ("d_quarter_seq", T.BIGINT),
        ("d_year", T.BIGINT), ("d_dow", T.BIGINT), ("d_moy", T.BIGINT),
        ("d_dom", T.BIGINT), ("d_qoy", T.BIGINT),
        ("d_fy_year", T.BIGINT), ("d_fy_quarter_seq", T.BIGINT),
        ("d_fy_week_seq", T.BIGINT),
        ("d_day_name", T.VarcharType(9)),
        ("d_quarter_name", T.VarcharType(6)),
        ("d_holiday", T.VarcharType(1)),
        ("d_weekend", T.VarcharType(1)),
        ("d_following_holiday", T.VarcharType(1)),
        ("d_first_dom", T.BIGINT), ("d_last_dom", T.BIGINT),
        ("d_same_day_ly", T.BIGINT), ("d_same_day_lq", T.BIGINT),
        ("d_current_day", T.VarcharType(1)),
        ("d_current_week", T.VarcharType(1)),
        ("d_current_month", T.VarcharType(1)),
        ("d_current_quarter", T.VarcharType(1)),
        ("d_current_year", T.VarcharType(1))), None),
    "time_dim": ((
        ("t_time_sk", T.BIGINT), ("t_time_id", T.VarcharType(16)),
        ("t_time", T.BIGINT), ("t_hour", T.BIGINT),
        ("t_minute", T.BIGINT), ("t_second", T.BIGINT),
        ("t_am_pm", T.VarcharType(2)), ("t_meal_time", T.VarcharType(20)),
        ("t_shift", T.VarcharType(20)),
        ("t_sub_shift", T.VarcharType(20))), None),  # fixed 86400
    "item": ((
        ("i_item_sk", T.BIGINT), ("i_item_id", T.VarcharType(16)),
        ("i_rec_start_date", T.DATE), ("i_rec_end_date", T.DATE),
        ("i_item_desc", T.VarcharType(200)), ("i_current_price", _D7_2),
        ("i_wholesale_cost", _D7_2), ("i_brand_id", T.BIGINT),
        ("i_brand", T.VarcharType(50)), ("i_class_id", T.BIGINT),
        ("i_class", T.VarcharType(50)), ("i_category_id", T.BIGINT),
        ("i_category", T.VarcharType(50)), ("i_manufact_id", T.BIGINT),
        ("i_manufact", T.VarcharType(50)), ("i_size", T.VarcharType(20)),
        ("i_formulation", T.VarcharType(20)), ("i_color", T.VarcharType(20)),
        ("i_units", T.VarcharType(10)), ("i_container", T.VarcharType(10)),
        ("i_manager_id", T.BIGINT),
        ("i_product_name", T.VarcharType(50))), 18_000),
    "customer": ((
        ("c_customer_sk", T.BIGINT), ("c_customer_id", T.VarcharType(16)),
        ("c_current_cdemo_sk", T.BIGINT), ("c_current_hdemo_sk", T.BIGINT),
        ("c_current_addr_sk", T.BIGINT), ("c_first_shipto_date_sk", T.BIGINT),
        ("c_first_sales_date_sk", T.BIGINT),
        ("c_salutation", T.VarcharType(10)),
        ("c_first_name", T.VarcharType(20)),
        ("c_last_name", T.VarcharType(30)),
        ("c_preferred_cust_flag", T.VarcharType(1)),
        ("c_birth_day", T.BIGINT), ("c_birth_month", T.BIGINT),
        ("c_birth_year", T.BIGINT),
        ("c_birth_country", T.VarcharType(20)),
        ("c_login", T.VarcharType(13)),
        ("c_email_address", T.VarcharType(50)),
        ("c_last_review_date_sk", T.BIGINT)), 100_000),
    "customer_address": ((
        ("ca_address_sk", T.BIGINT), ("ca_address_id", T.VarcharType(16)),
        ("ca_street_number", T.VarcharType(10)),
        ("ca_street_name", T.VarcharType(60)),
        ("ca_street_type", T.VarcharType(15)),
        ("ca_suite_number", T.VarcharType(10)),
        ("ca_city", T.VarcharType(60)), ("ca_county", T.VarcharType(30)),
        ("ca_state", T.VarcharType(2)), ("ca_zip", T.VarcharType(10)),
        ("ca_country", T.VarcharType(20)),
        ("ca_gmt_offset", _D5_2),
        ("ca_location_type", T.VarcharType(20))), 50_000),
    "customer_demographics": ((
        ("cd_demo_sk", T.BIGINT), ("cd_gender", T.VarcharType(1)),
        ("cd_marital_status", T.VarcharType(1)),
        ("cd_education_status", T.VarcharType(20)),
        ("cd_purchase_estimate", T.BIGINT),
        ("cd_credit_rating", T.VarcharType(10)),
        ("cd_dep_count", T.BIGINT),
        ("cd_dep_employed_count", T.BIGINT),
        ("cd_dep_college_count", T.BIGINT)), 1_920_800),
    "household_demographics": ((
        ("hd_demo_sk", T.BIGINT), ("hd_income_band_sk", T.BIGINT),
        ("hd_buy_potential", T.VarcharType(15)), ("hd_dep_count", T.BIGINT),
        ("hd_vehicle_count", T.BIGINT)), None),   # fixed 7200
    "income_band": ((
        ("ib_income_band_sk", T.BIGINT), ("ib_lower_bound", T.BIGINT),
        ("ib_upper_bound", T.BIGINT)), None),      # fixed 20
    "store": ((
        ("s_store_sk", T.BIGINT), ("s_store_id", T.VarcharType(16)),
        ("s_rec_start_date", T.DATE), ("s_rec_end_date", T.DATE),
        ("s_closed_date_sk", T.BIGINT),
        ("s_store_name", T.VarcharType(50)),
        ("s_number_employees", T.BIGINT), ("s_floor_space", T.BIGINT),
        ("s_hours", T.VarcharType(20)), ("s_manager", T.VarcharType(40)),
        ("s_market_id", T.BIGINT),
        ("s_geography_class", T.VarcharType(100)),
        ("s_market_desc", T.VarcharType(100)),
        ("s_market_manager", T.VarcharType(40)),
        ("s_division_id", T.BIGINT), ("s_division_name", T.VarcharType(50)),
        ("s_company_id", T.BIGINT), ("s_company_name", T.VarcharType(50)),
        ("s_street_number", T.VarcharType(10)),
        ("s_street_name", T.VarcharType(60)),
        ("s_street_type", T.VarcharType(15)),
        ("s_suite_number", T.VarcharType(10)),
        ("s_city", T.VarcharType(60)),
        ("s_county", T.VarcharType(30)), ("s_state", T.VarcharType(2)),
        ("s_zip", T.VarcharType(10)), ("s_country", T.VarcharType(20)),
        ("s_gmt_offset", _D5_2),
        ("s_tax_precentage", _D5_2)), 12),  # spec's own spelling
    "warehouse": ((
        ("w_warehouse_sk", T.BIGINT), ("w_warehouse_id", T.VarcharType(16)),
        ("w_warehouse_name", T.VarcharType(20)),
        ("w_warehouse_sq_ft", T.BIGINT),
        ("w_street_number", T.VarcharType(10)),
        ("w_street_name", T.VarcharType(60)),
        ("w_street_type", T.VarcharType(15)),
        ("w_suite_number", T.VarcharType(10)),
        ("w_city", T.VarcharType(60)), ("w_county", T.VarcharType(30)),
        ("w_state", T.VarcharType(2)), ("w_zip", T.VarcharType(10)),
        ("w_country", T.VarcharType(20)),
        ("w_gmt_offset", _D5_2)), 5),
    "promotion": ((
        ("p_promo_sk", T.BIGINT), ("p_promo_id", T.VarcharType(16)),
        ("p_start_date_sk", T.BIGINT), ("p_end_date_sk", T.BIGINT),
        ("p_item_sk", T.BIGINT), ("p_cost", T.DecimalType(15, 2)),
        ("p_response_target", T.BIGINT),
        ("p_promo_name", T.VarcharType(50)),
        ("p_channel_dmail", T.VarcharType(1)),
        ("p_channel_email", T.VarcharType(1)),
        ("p_channel_catalog", T.VarcharType(1)),
        ("p_channel_tv", T.VarcharType(1)),
        ("p_channel_radio", T.VarcharType(1)),
        ("p_channel_press", T.VarcharType(1)),
        ("p_channel_event", T.VarcharType(1)),
        ("p_channel_demo", T.VarcharType(1)),
        ("p_channel_details", T.VarcharType(100)),
        ("p_purpose", T.VarcharType(15)),
        ("p_discount_active", T.VarcharType(1))), 300),
    "web_site": ((
        ("web_site_sk", T.BIGINT), ("web_site_id", T.VarcharType(16)),
        ("web_rec_start_date", T.DATE), ("web_rec_end_date", T.DATE),
        ("web_name", T.VarcharType(50)),
        ("web_open_date_sk", T.BIGINT), ("web_close_date_sk", T.BIGINT),
        ("web_class", T.VarcharType(50)), ("web_manager", T.VarcharType(40)),
        ("web_mkt_id", T.BIGINT), ("web_mkt_class", T.VarcharType(50)),
        ("web_mkt_desc", T.VarcharType(100)),
        ("web_market_manager", T.VarcharType(40)),
        ("web_company_id", T.BIGINT),
        ("web_company_name", T.VarcharType(50)),
        ("web_street_number", T.VarcharType(10)),
        ("web_street_name", T.VarcharType(60)),
        ("web_street_type", T.VarcharType(15)),
        ("web_suite_number", T.VarcharType(10)),
        ("web_city", T.VarcharType(60)), ("web_county", T.VarcharType(30)),
        ("web_state", T.VarcharType(2)), ("web_zip", T.VarcharType(10)),
        ("web_country", T.VarcharType(20)),
        ("web_gmt_offset", _D5_2),
        ("web_tax_percentage", _D5_2)), 30),
    "web_page": ((
        ("wp_web_page_sk", T.BIGINT), ("wp_web_page_id", T.VarcharType(16)),
        ("wp_rec_start_date", T.DATE), ("wp_rec_end_date", T.DATE),
        ("wp_creation_date_sk", T.BIGINT), ("wp_access_date_sk", T.BIGINT),
        ("wp_autogen_flag", T.VarcharType(1)), ("wp_customer_sk", T.BIGINT),
        ("wp_url", T.VarcharType(100)), ("wp_type", T.VarcharType(50)),
        ("wp_char_count", T.BIGINT), ("wp_link_count", T.BIGINT),
        ("wp_image_count", T.BIGINT),
        ("wp_max_ad_count", T.BIGINT)), 60),
    "catalog_page": ((
        ("cp_catalog_page_sk", T.BIGINT),
        ("cp_catalog_page_id", T.VarcharType(16)),
        ("cp_start_date_sk", T.BIGINT), ("cp_end_date_sk", T.BIGINT),
        ("cp_department", T.VarcharType(50)),
        ("cp_catalog_number", T.BIGINT),
        ("cp_catalog_page_number", T.BIGINT),
        ("cp_description", T.VarcharType(100)),
        ("cp_type", T.VarcharType(100))), 11_718),
    "call_center": ((
        ("cc_call_center_sk", T.BIGINT),
        ("cc_call_center_id", T.VarcharType(16)),
        ("cc_rec_start_date", T.DATE), ("cc_rec_end_date", T.DATE),
        ("cc_closed_date_sk", T.BIGINT), ("cc_open_date_sk", T.BIGINT),
        ("cc_name", T.VarcharType(50)), ("cc_class", T.VarcharType(50)),
        ("cc_employees", T.BIGINT), ("cc_sq_ft", T.BIGINT),
        ("cc_hours", T.VarcharType(20)), ("cc_manager", T.VarcharType(40)),
        ("cc_mkt_id", T.BIGINT), ("cc_mkt_class", T.VarcharType(50)),
        ("cc_mkt_desc", T.VarcharType(100)),
        ("cc_market_manager", T.VarcharType(40)),
        ("cc_division", T.BIGINT), ("cc_division_name", T.VarcharType(50)),
        ("cc_company", T.BIGINT), ("cc_company_name", T.VarcharType(50)),
        ("cc_street_number", T.VarcharType(10)),
        ("cc_street_name", T.VarcharType(60)),
        ("cc_street_type", T.VarcharType(15)),
        ("cc_suite_number", T.VarcharType(10)),
        ("cc_city", T.VarcharType(60)), ("cc_county", T.VarcharType(30)),
        ("cc_state", T.VarcharType(2)), ("cc_zip", T.VarcharType(10)),
        ("cc_country", T.VarcharType(20)),
        ("cc_gmt_offset", _D5_2),
        ("cc_tax_percentage", _D5_2)), 6),
    "ship_mode": ((
        ("sm_ship_mode_sk", T.BIGINT),
        ("sm_ship_mode_id", T.VarcharType(16)),
        ("sm_type", T.VarcharType(30)), ("sm_code", T.VarcharType(10)),
        ("sm_carrier", T.VarcharType(20)),
        ("sm_contract", T.VarcharType(20))), None),  # fixed 20
    "reason": ((
        ("r_reason_sk", T.BIGINT), ("r_reason_id", T.VarcharType(16)),
        ("r_reason_desc", T.VarcharType(100))), 35),
    "inventory": ((
        ("inv_date_sk", T.BIGINT), ("inv_item_sk", T.BIGINT),
        ("inv_warehouse_sk", T.BIGINT),
        ("inv_quantity_on_hand", T.BIGINT)), None),  # items x wh x weeks
    "store_sales": ((
        ("ss_sold_date_sk", T.BIGINT), ("ss_sold_time_sk", T.BIGINT),
        ("ss_item_sk", T.BIGINT),
        ("ss_customer_sk", T.BIGINT), ("ss_cdemo_sk", T.BIGINT),
        ("ss_hdemo_sk", T.BIGINT), ("ss_addr_sk", T.BIGINT),
        ("ss_store_sk", T.BIGINT), ("ss_promo_sk", T.BIGINT),
        ("ss_ticket_number", T.BIGINT), ("ss_quantity", T.BIGINT),
        ("ss_wholesale_cost", _D7_2), ("ss_list_price", _D7_2),
        ("ss_sales_price", _D7_2), ("ss_ext_discount_amt", _D7_2),
        ("ss_ext_sales_price", _D7_2), ("ss_ext_wholesale_cost", _D7_2),
        ("ss_ext_list_price", _D7_2), ("ss_ext_tax", _D7_2),
        ("ss_coupon_amt", _D7_2),
        ("ss_net_paid", _D7_2), ("ss_net_paid_inc_tax", _D7_2),
        ("ss_net_profit", _D7_2)), 2_880_404),
    "store_returns": ((
        ("sr_returned_date_sk", T.BIGINT), ("sr_return_time_sk", T.BIGINT),
        ("sr_item_sk", T.BIGINT),
        ("sr_customer_sk", T.BIGINT), ("sr_cdemo_sk", T.BIGINT),
        ("sr_hdemo_sk", T.BIGINT), ("sr_addr_sk", T.BIGINT),
        ("sr_store_sk", T.BIGINT), ("sr_reason_sk", T.BIGINT),
        ("sr_ticket_number", T.BIGINT),
        ("sr_return_quantity", T.BIGINT), ("sr_return_amt", _D7_2),
        ("sr_return_tax", _D7_2), ("sr_return_amt_inc_tax", _D7_2),
        ("sr_fee", _D7_2), ("sr_return_ship_cost", _D7_2),
        ("sr_refunded_cash", _D7_2), ("sr_reversed_charge", _D7_2),
        ("sr_store_credit", _D7_2),
        ("sr_net_loss", _D7_2)), None),            # ~10% of store_sales
    "catalog_sales": ((
        ("cs_sold_date_sk", T.BIGINT), ("cs_sold_time_sk", T.BIGINT),
        ("cs_ship_date_sk", T.BIGINT),
        ("cs_bill_customer_sk", T.BIGINT), ("cs_bill_cdemo_sk", T.BIGINT),
        ("cs_bill_hdemo_sk", T.BIGINT), ("cs_bill_addr_sk", T.BIGINT),
        ("cs_ship_customer_sk", T.BIGINT), ("cs_ship_cdemo_sk", T.BIGINT),
        ("cs_ship_hdemo_sk", T.BIGINT), ("cs_ship_addr_sk", T.BIGINT),
        ("cs_call_center_sk", T.BIGINT), ("cs_catalog_page_sk", T.BIGINT),
        ("cs_ship_mode_sk", T.BIGINT),
        ("cs_warehouse_sk", T.BIGINT), ("cs_item_sk", T.BIGINT),
        ("cs_promo_sk", T.BIGINT), ("cs_order_number", T.BIGINT),
        ("cs_quantity", T.BIGINT), ("cs_wholesale_cost", _D7_2),
        ("cs_list_price", _D7_2), ("cs_sales_price", _D7_2),
        ("cs_ext_discount_amt", _D7_2), ("cs_ext_sales_price", _D7_2),
        ("cs_ext_wholesale_cost", _D7_2), ("cs_ext_list_price", _D7_2),
        ("cs_ext_tax", _D7_2), ("cs_coupon_amt", _D7_2),
        ("cs_ext_ship_cost", _D7_2),
        ("cs_net_paid", _D7_2), ("cs_net_paid_inc_tax", _D7_2),
        ("cs_net_paid_inc_ship", _D7_2),
        ("cs_net_paid_inc_ship_tax", _D7_2),
        ("cs_net_profit", _D7_2)), 1_441_548),
    "catalog_returns": ((
        ("cr_returned_date_sk", T.BIGINT),
        ("cr_returned_time_sk", T.BIGINT), ("cr_item_sk", T.BIGINT),
        ("cr_refunded_customer_sk", T.BIGINT),
        ("cr_refunded_cdemo_sk", T.BIGINT),
        ("cr_refunded_hdemo_sk", T.BIGINT),
        ("cr_refunded_addr_sk", T.BIGINT),
        ("cr_returning_customer_sk", T.BIGINT),
        ("cr_returning_cdemo_sk", T.BIGINT),
        ("cr_returning_hdemo_sk", T.BIGINT),
        ("cr_returning_addr_sk", T.BIGINT),
        ("cr_call_center_sk", T.BIGINT), ("cr_catalog_page_sk", T.BIGINT),
        ("cr_ship_mode_sk", T.BIGINT), ("cr_warehouse_sk", T.BIGINT),
        ("cr_reason_sk", T.BIGINT), ("cr_order_number", T.BIGINT),
        ("cr_return_quantity", T.BIGINT), ("cr_return_amount", _D7_2),
        ("cr_return_tax", _D7_2), ("cr_return_amt_inc_tax", _D7_2),
        ("cr_fee", _D7_2), ("cr_return_ship_cost", _D7_2),
        ("cr_refunded_cash", _D7_2), ("cr_reversed_charge", _D7_2),
        ("cr_store_credit", _D7_2), ("cr_net_loss", _D7_2)), None),
    "web_sales": ((
        ("ws_sold_date_sk", T.BIGINT), ("ws_sold_time_sk", T.BIGINT),
        ("ws_ship_date_sk", T.BIGINT), ("ws_item_sk", T.BIGINT),
        ("ws_bill_customer_sk", T.BIGINT), ("ws_bill_cdemo_sk", T.BIGINT),
        ("ws_bill_hdemo_sk", T.BIGINT), ("ws_bill_addr_sk", T.BIGINT),
        ("ws_ship_customer_sk", T.BIGINT), ("ws_ship_cdemo_sk", T.BIGINT),
        ("ws_ship_hdemo_sk", T.BIGINT), ("ws_ship_addr_sk", T.BIGINT),
        ("ws_web_page_sk", T.BIGINT), ("ws_web_site_sk", T.BIGINT),
        ("ws_ship_mode_sk", T.BIGINT), ("ws_warehouse_sk", T.BIGINT),
        ("ws_promo_sk", T.BIGINT), ("ws_order_number", T.BIGINT),
        ("ws_quantity", T.BIGINT), ("ws_wholesale_cost", _D7_2),
        ("ws_list_price", _D7_2), ("ws_sales_price", _D7_2),
        ("ws_ext_discount_amt", _D7_2), ("ws_ext_sales_price", _D7_2),
        ("ws_ext_wholesale_cost", _D7_2), ("ws_ext_list_price", _D7_2),
        ("ws_ext_tax", _D7_2), ("ws_coupon_amt", _D7_2),
        ("ws_ext_ship_cost", _D7_2),
        ("ws_net_paid", _D7_2), ("ws_net_paid_inc_tax", _D7_2),
        ("ws_net_paid_inc_ship", _D7_2),
        ("ws_net_paid_inc_ship_tax", _D7_2),
        ("ws_net_profit", _D7_2)), 719_384),
    "web_returns": ((
        ("wr_returned_date_sk", T.BIGINT),
        ("wr_returned_time_sk", T.BIGINT), ("wr_item_sk", T.BIGINT),
        ("wr_refunded_customer_sk", T.BIGINT),
        ("wr_refunded_cdemo_sk", T.BIGINT),
        ("wr_refunded_hdemo_sk", T.BIGINT),
        ("wr_refunded_addr_sk", T.BIGINT),
        ("wr_returning_customer_sk", T.BIGINT),
        ("wr_returning_cdemo_sk", T.BIGINT),
        ("wr_returning_hdemo_sk", T.BIGINT),
        ("wr_returning_addr_sk", T.BIGINT),
        ("wr_web_page_sk", T.BIGINT), ("wr_reason_sk", T.BIGINT),
        ("wr_order_number", T.BIGINT),
        ("wr_return_quantity", T.BIGINT), ("wr_return_amt", _D7_2),
        ("wr_return_tax", _D7_2), ("wr_return_amt_inc_tax", _D7_2),
        ("wr_fee", _D7_2), ("wr_return_ship_cost", _D7_2),
        ("wr_refunded_cash", _D7_2), ("wr_reversed_charge", _D7_2),
        ("wr_account_credit", _D7_2), ("wr_net_loss", _D7_2)), None),
}

_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
               "Men", "Music", "Shoes", "Sports", "Women"]
_CLASSES = ["accent", "accessories", "archery", "arts", "athletic",
            "baseball", "bathroom", "bedding", "birdal", "blinds/shades",
            "camcorders", "classical", "computers", "country", "curtains",
            "decor", "diamonds", "dresses", "estate", "fiction", "fishing",
            "fitness", "flatware", "football", "fragrances", "furniture"]
_COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "black", "blanched", "blue", "blush", "brown", "burlywood",
           "burnished", "chartreuse", "chiffon", "chocolate", "coral",
           "cornflower", "cornsilk", "cream", "cyan", "dark", "deep", "dim",
           "dodger", "drab", "firebrick", "floral", "forest", "frosted",
           "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
           "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
           "lemon", "light", "lime", "linen", "magenta", "maroon", "medium",
           "metallic", "midnight", "mint", "misty", "moccasin", "navajo",
           "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
           "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
           "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
           "sienna", "sky", "slate", "smoke", "snow", "spring", "steel",
           "tan", "thistle", "tomato", "turquoise", "violet", "wheat",
           "white", "yellow"]
_SIZES = ["N/A", "extra large", "large", "medium", "petite", "small"]
_UNITS = ["Box", "Bunch", "Bundle", "Carton", "Case", "Cup", "Dozen",
          "Dram", "Each", "Gram", "Gross", "Lb", "N/A", "Ounce", "Oz",
          "Pallet", "Pound", "Tbl", "Ton", "Tsp", "Unknown"]
_STATES = ["AL", "CA", "FL", "GA", "IL", "IN", "KS", "KY", "LA", "MI",
           "MN", "MO", "NC", "NY", "OH", "OK", "PA", "SC", "TN", "TX",
           "VA", "WA", "WI"]
_BUY_POTENTIAL = [">10000", "0-500", "1001-5000", "501-1000", "5001-10000",
                  "Unknown"]
_EDUCATION = ["2 yr Degree", "4 yr Degree", "Advanced Degree", "College",
              "Primary", "Secondary", "Unknown"]
_CREDIT = ["Good", "High Risk", "Low Risk", "Unknown"]
_DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
              "Friday", "Saturday"]
_FIRST_NAMES = ["James", "John", "Robert", "Michael", "William", "David",
                "Mary", "Patricia", "Linda", "Barbara", "Elizabeth",
                "Jennifer", "Maria", "Susan", "Margaret", "Dorothy"]
_LAST_NAMES = ["Smith", "Johnson", "Williams", "Brown", "Jones", "Miller",
               "Davis", "Garcia", "Rodriguez", "Wilson", "Martinez",
               "Anderson", "Taylor", "Thomas", "Hernandez", "Moore"]
_CITIES = ["Fairview", "Midway", "Oak Grove", "Five Points", "Centerville",
           "Riverside", "Pleasant Hill", "Liberty", "Salem", "Union",
           "Greenville", "Franklin", "Spring Hill", "Shiloh", "Clinton"]

# sales span the calendar years 1998-2002 (dsdgen's active window)
_SALES_MIN = days_from_civil(1998, 1, 1) - _EPOCH_OFFSET + _JULIAN_BASE
_SALES_MAX = days_from_civil(2002, 12, 31) - _EPOCH_OFFSET + _JULIAN_BASE


def _table_seed(table: str, sf: float) -> int:
    return zlib.crc32(f"tpcds:{table}:{round(sf * 1000)}".encode())


def _scaled(base: int, sf: float, lo: int = 1) -> int:
    return max(lo, int(base * sf))


def _row_counts(sf: float) -> Dict[str, int]:
    n_ss = _scaled(2_880_404, sf)
    return {
        "date_dim": _DATE_ROWS,
        "time_dim": 86_400,
        "item": _scaled(18_000, sf, 10),
        "customer": _scaled(100_000, sf, 100),
        "customer_address": _scaled(50_000, sf, 50),
        # fixed-cardinality dimension in the spec; scaled below sf1 to keep
        # tiny-schema tests light
        "customer_demographics": _scaled(1_920_800, min(sf, 1.0) if sf >= 1.0
                                         else sf, 100),
        "household_demographics": 7_200,
        "income_band": 20,
        "store": _scaled(12, sf, 2),
        "warehouse": _scaled(5, sf, 1),
        "promotion": _scaled(300, sf, 10),
        "web_site": _scaled(30, sf, 2),
        "web_page": _scaled(60, sf, 2),
        "catalog_page": _scaled(11_718, sf, 100),
        "call_center": _scaled(6, sf, 2),
        "ship_mode": 20,
        "reason": _scaled(35, sf, 5),
        "store_sales": n_ss,
        "store_returns": max(1, n_ss // 10),
        "catalog_sales": _scaled(1_441_548, sf),
        "web_sales": _scaled(719_384, sf),
        "inventory": 0,    # derived: items x warehouses x weeks
        "catalog_returns": 0,  # derived: ~10% of catalog_sales
        "web_returns": 0,      # derived: ~10% of web_sales
    }


def _ids(prefix: str, n: int) -> np.ndarray:
    return np.array([f"{prefix}{i:012d}" for i in range(1, n + 1)],
                    dtype=object)


# far-future sentinel for rec_end_date-style columns (no NULLs in the
# materialized dims; engine and oracle read the same generated values, so
# comparisons stay consistent)
_OPEN_END_DATE = days_from_civil(2100, 1, 1)

_STREET_TYPES = ["Ave", "Blvd", "Boulevard", "Circle", "Court", "Dr",
                 "Drive", "Lane", "Ln", "Parkway", "Pkwy", "RD", "Road",
                 "ST", "Street", "Way"]


def _names(rng, n):
    f = np.array(_FIRST_NAMES, dtype=object)[
        rng.integers(0, len(_FIRST_NAMES), n)]
    last = np.array(_LAST_NAMES, dtype=object)[
        rng.integers(0, len(_LAST_NAMES), n)]
    return np.array([f"{a} {b}" for a, b in zip(f, last)], dtype=object)


def _phrases(rng, n, max_len):
    words = np.array(_CLASSES, dtype=object)
    picks = rng.integers(0, len(words), size=(n, 3))
    return np.array([" ".join(words[r])[:max_len] for r in picks],
                    dtype=object)


def _address_cols(prefix: str, rng, n) -> Dict[str, np.ndarray]:
    cities = np.array(_CITIES, dtype=object)[
        rng.integers(0, len(_CITIES), n)]
    states = np.array(_STATES, dtype=object)[
        rng.integers(0, len(_STATES), n)]
    return {
        f"{prefix}_street_number": np.array(
            [str(v) for v in rng.integers(1, 1000, n)], dtype=object),
        f"{prefix}_street_name": np.array(
            [f"{c} Street" for c in cities], dtype=object),
        f"{prefix}_street_type": np.array(_STREET_TYPES, dtype=object)[
            rng.integers(0, len(_STREET_TYPES), n)],
        f"{prefix}_suite_number": np.array(
            [f"Suite {v}" for v in rng.integers(0, 100, n)], dtype=object),
        f"{prefix}_city": cities,
        f"{prefix}_county": np.array(
            [f"{s} County" for s in states], dtype=object),
        f"{prefix}_state": states,
        f"{prefix}_zip": np.array(
            [f"{z:05d}" for z in rng.integers(10000, 99999, n)],
            dtype=object),
        f"{prefix}_country": np.full(n, "United States", dtype=object),
        f"{prefix}_gmt_offset": rng.choice(
            np.array([-1000, -900, -800, -700, -600, -500]),
            n).astype(np.int64),
    }


def _gen_table(table: str, sf: float) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(_table_seed(table, sf))
    counts = _row_counts(sf)

    if table == "date_dim":
        n = _DATE_ROWS
        sk = np.arange(_JULIAN_BASE, _JULIAN_BASE + n, dtype=np.int64)
        date = np.arange(_EPOCH_OFFSET, _EPOCH_OFFSET + n, dtype=np.int32)
        # civil fields via numpy datetime64 (exact calendar)
        d64 = date.astype("datetime64[D]")
        y = d64.astype("datetime64[Y]").astype(int) + 1970
        m = d64.astype("datetime64[M]").astype(int) % 12 + 1
        dom = (d64 - d64.astype("datetime64[M]")).astype(int) + 1
        dow = (date + 4) % 7            # 1970-01-01 was a Thursday; 0=Sunday
        week_seq = (np.arange(n) + 1) // 7 + 1
        month_seq = (y - 1900) * 12 + (m - 1)
        qoy = (m - 1) // 3 + 1
        holiday = np.where(rng.random(n) < 0.05, "Y", "N").astype(object)
        no = np.full(n, "N", dtype=object)
        return {
            "d_date_sk": sk,
            "d_date_id": _ids("D", n),
            "d_date": date,
            "d_month_seq": month_seq.astype(np.int64),
            "d_week_seq": week_seq.astype(np.int64),
            "d_quarter_seq": ((y - 1900) * 4 + qoy - 1).astype(np.int64),
            "d_year": y.astype(np.int64),
            "d_dow": dow.astype(np.int64),
            "d_moy": m.astype(np.int64),
            "d_dom": dom.astype(np.int64),
            "d_qoy": qoy.astype(np.int64),
            "d_fy_year": y.astype(np.int64),
            "d_fy_quarter_seq": ((y - 1900) * 4 + qoy - 1).astype(np.int64),
            "d_fy_week_seq": week_seq.astype(np.int64),
            "d_day_name": np.array(_DAY_NAMES, dtype=object)[dow],
            "d_quarter_name": np.array(
                [f"{yy}Q{q}" for yy, q in zip(y, qoy)], dtype=object),
            "d_holiday": holiday,
            "d_weekend": np.where((dow == 0) | (dow == 6), "Y", "N").astype(
                object),
            "d_following_holiday": np.roll(holiday, -1),
            "d_first_dom": (sk - dom + 1).astype(np.int64),
            "d_last_dom": (sk - dom + 28).astype(np.int64),
            "d_same_day_ly": (sk - 365).astype(np.int64),
            "d_same_day_lq": (sk - 91).astype(np.int64),
            "d_current_day": no, "d_current_week": no,
            "d_current_month": no, "d_current_quarter": no,
            "d_current_year": no,
        }

    if table == "time_dim":
        n = 86_400
        t = np.arange(n, dtype=np.int64)
        hour = t // 3600
        return {
            "t_time_sk": t,
            "t_time_id": _ids("T", n),
            "t_time": t,
            "t_hour": hour,
            "t_minute": (t % 3600) // 60,
            "t_second": t % 60,
            "t_am_pm": np.where(hour < 12, "AM", "PM").astype(object),
            "t_meal_time": np.select(
                [(hour >= 6) & (hour <= 8), (hour >= 11) & (hour <= 13),
                 (hour >= 18) & (hour <= 20)],
                [np.full(n, "breakfast", dtype=object),
                 np.full(n, "lunch", dtype=object),
                 np.full(n, "dinner", dtype=object)],
                default="").astype(object),
            "t_shift": np.array(["third", "first", "second"], dtype=object)[
                np.minimum(hour // 8, 2)],
            "t_sub_shift": np.array(
                ["night", "morning", "afternoon", "evening"],
                dtype=object)[np.minimum(hour // 6, 3)],
        }

    if table == "web_site":
        n = counts["web_site"]
        out = {
            "web_site_sk": np.arange(1, n + 1, dtype=np.int64),
            "web_site_id": _ids("WS", n),
            "web_rec_start_date": np.full(
                n, days_from_civil(1997, 8, 16), dtype=np.int32),
            "web_rec_end_date": np.full(n, _OPEN_END_DATE, dtype=np.int32),
            "web_name": np.array([f"site_{i}" for i in range(n)],
                                 dtype=object),
            "web_open_date_sk": rng.integers(
                _SALES_MIN - 1000, _SALES_MIN, n).astype(np.int64),
            "web_close_date_sk": rng.integers(
                _SALES_MAX, _SALES_MAX + 1000, n).astype(np.int64),
            "web_class": np.full(n, "Unknown", dtype=object),
            "web_manager": _names(rng, n),
            "web_mkt_id": rng.integers(1, 7, n).astype(np.int64),
            "web_mkt_class": _phrases(rng, n, 30),
            "web_mkt_desc": _phrases(rng, n, 60),
            "web_market_manager": _names(rng, n),
            "web_company_id": rng.integers(1, 7, n).astype(np.int64),
            "web_company_name": np.array(
                ["pri", "able", "ation", "bar", "ese", "cally"],
                dtype=object)[np.arange(n) % 6],
        }
        out.update(_address_cols("web", rng, n))
        out["web_tax_percentage"] = rng.integers(0, 13, n).astype(np.int64)
        return out

    if table == "web_page":
        n = counts["web_page"]
        return {
            "wp_web_page_sk": np.arange(1, n + 1, dtype=np.int64),
            "wp_web_page_id": _ids("WP", n),
            "wp_rec_start_date": np.full(
                n, days_from_civil(1997, 9, 3), dtype=np.int32),
            "wp_rec_end_date": np.full(n, _OPEN_END_DATE, dtype=np.int32),
            "wp_creation_date_sk": rng.integers(
                _SALES_MIN - 500, _SALES_MIN, n).astype(np.int64),
            "wp_access_date_sk": rng.integers(
                _SALES_MIN, _SALES_MAX, n).astype(np.int64),
            "wp_autogen_flag": np.array(["Y", "N"], dtype=object)[
                rng.integers(0, 2, n)],
            "wp_customer_sk": rng.integers(
                1, counts["customer"] + 1, n).astype(np.int64),
            "wp_url": np.full(n, "http://www.foo.com", dtype=object),
            "wp_type": np.array(
                ["ad", "dynamic", "feedback", "general", "order",
                 "protected", "welcome"], dtype=object)[
                rng.integers(0, 7, n)],
            "wp_char_count": rng.integers(100, 8000, n).astype(np.int64),
            "wp_link_count": rng.integers(2, 25, n).astype(np.int64),
            "wp_image_count": rng.integers(1, 7, n).astype(np.int64),
            "wp_max_ad_count": rng.integers(0, 5, n).astype(np.int64),
        }

    if table == "catalog_page":
        n = counts["catalog_page"]
        return {
            "cp_catalog_page_sk": np.arange(1, n + 1, dtype=np.int64),
            "cp_catalog_page_id": _ids("CP", n),
            "cp_start_date_sk": rng.integers(
                _SALES_MIN, _SALES_MAX - 100, n).astype(np.int64),
            "cp_end_date_sk": rng.integers(
                _SALES_MAX - 100, _SALES_MAX, n).astype(np.int64),
            "cp_department": np.full(n, "DEPARTMENT", dtype=object),
            "cp_catalog_number": (np.arange(n, dtype=np.int64) // 108 + 1),
            "cp_catalog_page_number": (np.arange(n, dtype=np.int64) % 108
                                       + 1),
            "cp_description": _phrases(rng, n, 60),
            "cp_type": np.array(
                ["bi-annual", "monthly", "quarterly"], dtype=object)[
                rng.integers(0, 3, n)],
        }

    if table == "call_center":
        n = counts["call_center"]
        out = {
            "cc_call_center_sk": np.arange(1, n + 1, dtype=np.int64),
            "cc_call_center_id": _ids("CC", n),
            "cc_rec_start_date": np.full(
                n, days_from_civil(1998, 1, 1), dtype=np.int32),
            "cc_rec_end_date": np.full(n, _OPEN_END_DATE, dtype=np.int32),
            "cc_closed_date_sk": np.zeros(n, np.int64),
            "cc_open_date_sk": rng.integers(
                _SALES_MIN - 1000, _SALES_MIN, n).astype(np.int64),
            "cc_name": np.array(
                ["NY Metro", "Mid Atlantic", "Pacific Northwest",
                 "North Midwest", "California", "Hawaii/Alaska"],
                dtype=object)[np.arange(n) % 6],
            "cc_class": np.array(["small", "medium", "large"],
                                 dtype=object)[np.arange(n) % 3],
            "cc_employees": rng.integers(1, 7, n).astype(np.int64) * 100,
            "cc_sq_ft": rng.integers(1, 10, n).astype(np.int64) * 10_000,
            "cc_hours": np.array(["8AM-4PM", "8AM-12AM", "8AM-8AM"],
                                 dtype=object)[np.arange(n) % 3],
            "cc_manager": _names(rng, n),
            "cc_mkt_id": rng.integers(1, 7, n).astype(np.int64),
            "cc_mkt_class": _phrases(rng, n, 30),
            "cc_mkt_desc": _phrases(rng, n, 60),
            "cc_market_manager": _names(rng, n),
            "cc_division": rng.integers(1, 7, n).astype(np.int64),
            "cc_division_name": np.array(
                ["pri", "able", "ation", "bar", "ese", "cally"],
                dtype=object)[np.arange(n) % 6],
            "cc_company": rng.integers(1, 7, n).astype(np.int64),
            "cc_company_name": np.array(
                ["pri", "able", "ation", "bar", "ese", "cally"],
                dtype=object)[np.arange(n) % 6],
        }
        out.update(_address_cols("cc", rng, n))
        out["cc_tax_percentage"] = rng.integers(0, 13, n).astype(np.int64)
        return out

    if table == "ship_mode":
        n = 20
        types = ["EXPRESS", "LIBRARY", "NEXT DAY", "OVERNIGHT", "REGULAR",
                 "TWO DAY"]
        carriers = ["AIRBORNE", "ALLIANCE", "BARIAN", "BOXBUNDLES", "DHL",
                    "DIAMOND", "FEDEX", "GERMA", "GREAT EASTERN", "HARMSTORF",
                    "LATVIAN", "MSC", "ORIENTAL", "PRIVATECARRIER", "RUPEKSA",
                    "TBS", "UPS", "USPS", "ZHOU", "ZOUROS"]
        return {
            "sm_ship_mode_sk": np.arange(1, n + 1, dtype=np.int64),
            "sm_ship_mode_id": _ids("SM", n),
            "sm_type": np.array(types, dtype=object)[np.arange(n) % 6],
            "sm_code": np.array(["AIR", "SURFACE", "SEA"], dtype=object)[
                np.arange(n) % 3],
            "sm_carrier": np.array(carriers, dtype=object),
            "sm_contract": _ids("K", n),
        }

    if table == "reason":
        n = counts["reason"]
        reasons = ["Package was damaged", "Stopped working",
                   "Did not get it on time", "Not the product that was "
                   "ordred", "Parts missing", "Does not work with a product "
                   "that I have", "Gift exchange", "Did not like the color",
                   "Did not like the model", "Did not like the make",
                   "Did not like the warranty", "No service location in my "
                   "area", "Found a better price in a store",
                   "Found a better extended warranty in a store",
                   "reason 15", "reason 16", "reason 17", "reason 18",
                   "reason 19", "reason 20", "reason 21", "reason 22",
                   "reason 23", "reason 24", "reason 25", "reason 26",
                   "reason 27", "reason 28", "reason 29", "reason 30",
                   "reason 31", "reason 32", "reason 33", "reason 34",
                   "reason 35"]
        return {
            "r_reason_sk": np.arange(1, n + 1, dtype=np.int64),
            "r_reason_id": _ids("R", n),
            "r_reason_desc": np.array(reasons[:n] if n <= 35 else
                                      [reasons[i % 35] for i in range(n)],
                                      dtype=object),
        }

    if table == "item":
        n = counts["item"]
        cat_id = rng.integers(1, 11, n)
        class_id = rng.integers(1, 17, n)
        brand_id = cat_id * 1000000 + class_id * 1000 + rng.integers(1, 11, n)
        manu_id = rng.integers(1, 1001, n)
        return {
            "i_item_sk": np.arange(1, n + 1, dtype=np.int64),
            "i_item_id": _ids("I", n),
            "i_rec_start_date": np.full(
                n, days_from_civil(1997, 10, 27), dtype=np.int32),
            "i_rec_end_date": np.full(n, _OPEN_END_DATE, dtype=np.int32),
            "i_item_desc": np.array(
                [f"item description {i % 997}" for i in range(n)],
                dtype=object),
            "i_current_price": rng.integers(50, 30000, n).astype(np.int64),
            "i_wholesale_cost": rng.integers(30, 20000, n).astype(np.int64),
            "i_brand_id": brand_id.astype(np.int64),
            "i_brand": np.array([f"brand#{b % 1000}" for b in brand_id],
                                dtype=object),
            "i_class_id": class_id.astype(np.int64),
            "i_class": np.array(_CLASSES, dtype=object)[
                class_id % len(_CLASSES)],
            "i_category_id": cat_id.astype(np.int64),
            "i_category": np.array(_CATEGORIES, dtype=object)[cat_id - 1],
            "i_manufact_id": manu_id.astype(np.int64),
            "i_manufact": np.array([f"manufact#{m % 997}" for m in manu_id],
                                   dtype=object),
            "i_size": np.array(_SIZES, dtype=object)[
                rng.integers(0, len(_SIZES), n)],
            "i_formulation": np.array(
                [f"formulation {v}" for v in rng.integers(0, 997, n)],
                dtype=object),
            "i_color": np.array(_COLORS, dtype=object)[
                rng.integers(0, len(_COLORS), n)],
            "i_units": np.array(_UNITS, dtype=object)[
                rng.integers(0, len(_UNITS), n)],
            "i_container": np.full(n, "Unknown", dtype=object),
            "i_manager_id": rng.integers(1, 101, n).astype(np.int64),
            "i_product_name": np.array(
                [f"product{i % 4999}ought" for i in range(n)], dtype=object),
        }

    if table == "customer":
        n = counts["customer"]
        first_sale = rng.integers(_SALES_MIN - 1500, _SALES_MIN, n)
        return {
            "c_customer_sk": np.arange(1, n + 1, dtype=np.int64),
            "c_customer_id": _ids("C", n),
            "c_current_cdemo_sk": rng.integers(
                1, counts["customer_demographics"] + 1, n).astype(np.int64),
            "c_current_hdemo_sk": rng.integers(1, 7201, n).astype(np.int64),
            "c_current_addr_sk": rng.integers(
                1, counts["customer_address"] + 1, n).astype(np.int64),
            "c_first_shipto_date_sk": (first_sale + 30).astype(np.int64),
            "c_first_sales_date_sk": first_sale.astype(np.int64),
            "c_salutation": np.array(
                ["Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"],
                dtype=object)[rng.integers(0, 6, n)],
            "c_first_name": np.array(_FIRST_NAMES, dtype=object)[
                rng.integers(0, len(_FIRST_NAMES), n)],
            "c_last_name": np.array(_LAST_NAMES, dtype=object)[
                rng.integers(0, len(_LAST_NAMES), n)],
            "c_preferred_cust_flag": np.array(["Y", "N"], dtype=object)[
                rng.integers(0, 2, n)],
            "c_birth_day": rng.integers(1, 29, n).astype(np.int64),
            "c_birth_month": rng.integers(1, 13, n).astype(np.int64),
            "c_birth_year": rng.integers(1924, 1993, n).astype(np.int64),
            "c_birth_country": np.array(
                ["UNITED STATES", "CANADA", "GERMANY", "JAPAN", "MEXICO",
                 "FRANCE", "BRAZIL", "INDIA"], dtype=object)[
                rng.integers(0, 8, n)],
            "c_login": np.full(n, "", dtype=object),
            "c_email_address": np.array(
                [f"user{i % 9973}@example.com" for i in range(n)],
                dtype=object),
            "c_last_review_date_sk": rng.integers(
                _SALES_MIN, _SALES_MAX, n).astype(np.int64),
        }

    if table == "customer_address":
        n = counts["customer_address"]
        out = {
            "ca_address_sk": np.arange(1, n + 1, dtype=np.int64),
            "ca_address_id": _ids("A", n),
            "ca_location_type": np.array(
                ["apartment", "condo", "single family"], dtype=object)[
                rng.integers(0, 3, n)],
        }
        out.update(_address_cols("ca", rng, n))
        return out

    if table == "customer_demographics":
        n = counts["customer_demographics"]
        seq = np.arange(n)
        return {
            "cd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
            "cd_gender": np.array(["M", "F"], dtype=object)[seq % 2],
            "cd_marital_status": np.array(
                ["M", "S", "D", "W", "U"], dtype=object)[(seq // 2) % 5],
            "cd_education_status": np.array(_EDUCATION, dtype=object)[
                (seq // 10) % len(_EDUCATION)],
            "cd_purchase_estimate": ((seq // 70) % 20 * 500 + 500).astype(
                np.int64),
            "cd_credit_rating": np.array(_CREDIT, dtype=object)[
                (seq // 1400) % len(_CREDIT)],
            "cd_dep_count": ((seq // 5600) % 7).astype(np.int64),
            "cd_dep_employed_count": ((seq // 39200) % 7).astype(np.int64),
            "cd_dep_college_count": ((seq // 274400) % 7).astype(np.int64),
        }

    if table == "household_demographics":
        n = 7200
        seq = np.arange(n)
        return {
            "hd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
            "hd_income_band_sk": (seq % 20 + 1).astype(np.int64),
            "hd_buy_potential": np.array(_BUY_POTENTIAL, dtype=object)[
                (seq // 20) % len(_BUY_POTENTIAL)],
            "hd_dep_count": ((seq // 120) % 10).astype(np.int64),
            "hd_vehicle_count": ((seq // 1200) % 6).astype(np.int64),
        }

    if table == "income_band":
        n = 20
        lower = np.arange(n, dtype=np.int64) * 10000
        return {
            "ib_income_band_sk": np.arange(1, n + 1, dtype=np.int64),
            "ib_lower_bound": lower + np.where(np.arange(n) == 0, 0, 1),
            "ib_upper_bound": lower + 10000,
        }

    if table == "store":
        n = counts["store"]
        out = {
            "s_store_sk": np.arange(1, n + 1, dtype=np.int64),
            "s_store_id": _ids("S", n),
            "s_rec_start_date": np.full(
                n, days_from_civil(1997, 3, 13), dtype=np.int32),
            "s_rec_end_date": np.full(n, _OPEN_END_DATE, dtype=np.int32),
            "s_closed_date_sk": np.zeros(n, np.int64),
            "s_store_name": np.array(
                ["able", "ation", "bar", "ese", "eing", "cally", "ought",
                 "anti"], dtype=object)[np.arange(n) % 8],
            "s_number_employees": rng.integers(200, 300, n).astype(np.int64),
            "s_floor_space": rng.integers(5_000_000, 10_000_000, n).astype(
                np.int64),
            "s_hours": np.array(["8AM-4PM", "8AM-12AM", "8AM-8AM"],
                                dtype=object)[np.arange(n) % 3],
            "s_manager": _names(rng, n),
            "s_market_id": rng.integers(1, 11, n).astype(np.int64),
            "s_geography_class": np.full(n, "Unknown", dtype=object),
            "s_market_desc": _phrases(rng, n, 60),
            "s_market_manager": _names(rng, n),
            "s_division_id": np.ones(n, np.int64),
            "s_division_name": np.full(n, "Unknown", dtype=object),
            "s_company_id": np.ones(n, np.int64),
            "s_company_name": np.full(n, "Unknown", dtype=object),
        }
        out.update(_address_cols("s", rng, n))
        out["s_tax_precentage"] = rng.integers(0, 12, n).astype(np.int64)
        return out

    if table == "warehouse":
        n = counts["warehouse"]
        out = {
            "w_warehouse_sk": np.arange(1, n + 1, dtype=np.int64),
            "w_warehouse_id": _ids("W", n),
            "w_warehouse_name": np.array(
                [f"Warehouse {i}" for i in range(1, n + 1)], dtype=object),
            "w_warehouse_sq_ft": rng.integers(50_000, 1_000_000, n).astype(
                np.int64),
        }
        out.update(_address_cols("w", rng, n))
        return out

    if table == "promotion":
        n = counts["promotion"]
        start = rng.integers(_SALES_MIN, _SALES_MAX - 60, n)

        def yn(col_seed):
            r2 = np.random.default_rng(_table_seed(table, sf) + col_seed)
            return np.array(["Y", "N"], dtype=object)[r2.integers(0, 2, n)]
        return {
            "p_promo_sk": np.arange(1, n + 1, dtype=np.int64),
            "p_promo_id": _ids("P", n),
            "p_start_date_sk": start.astype(np.int64),
            "p_end_date_sk": (start + rng.integers(10, 60, n)).astype(
                np.int64),
            "p_item_sk": rng.integers(1, counts["item"] + 1, n).astype(
                np.int64),
            "p_cost": np.full(n, 100000, np.int64),   # 1000.00
            "p_response_target": np.ones(n, np.int64),
            "p_promo_name": np.array(
                ["able", "ation", "bar", "ese", "eing", "cally", "ought",
                 "anti", "pri", "n st"], dtype=object)[np.arange(n) % 10],
            "p_channel_dmail": yn(1),
            "p_channel_email": yn(2),
            "p_channel_catalog": yn(3),
            "p_channel_tv": yn(4),
            "p_channel_radio": yn(5),
            "p_channel_press": yn(6),
            "p_channel_event": yn(7),
            "p_channel_demo": yn(8),
            "p_channel_details": _phrases(rng, n, 60),
            "p_purpose": np.full(n, "Unknown", dtype=object),
            "p_discount_active": yn(9),
        }

    raise KeyError(table)


_TABLE_CACHE: Dict[tuple, Dict[str, np.ndarray]] = {}
_DICT_CACHE: Dict[tuple, Dictionary] = {}


# --------------------------------------------------------------------------
# chunked fact streams (round 4): the big tables become stateless
# counter-hash column streams (the tpch_gen design — any column, any row
# range, identical bytes everywhere), which is what makes SF100 q64/q72
# runnable: store_sales SF100 is 288M rows and a scan materializes only the
# columns it reads, chunk by chunk, with no sequential RNG state. The
# dimension tables keep the materialized generator (small).

_CHUNKED = {"store_sales", "store_returns", "catalog_sales",
            "catalog_returns", "web_sales", "web_returns",
            "inventory", "customer_demographics"}


def _hui(table, col, sf, idx, lo, hi):
    return _HG._ui("tpcds." + table, col, sf, idx, lo, hi)


def _hu64(table, col, sf, idx):
    return _HG._u64("tpcds." + table, col, sf, idx)


def _ss_col(sf, col, idx, c):
    t = "store_sales"
    if col == "ss_sold_date_sk":
        return _hui(t, col, sf, idx, _SALES_MIN, _SALES_MAX)
    if col == "ss_sold_time_sk":
        return _hui(t, col, sf, idx, 28800, 75599)   # store hours
    if col == "ss_item_sk":
        return _hui(t, col, sf, idx, 1, c["item"])
    if col == "ss_customer_sk":
        return _hui(t, col, sf, idx, 1, c["customer"])
    if col == "ss_cdemo_sk":
        return _hui(t, col, sf, idx, 1, c["customer_demographics"])
    if col == "ss_hdemo_sk":
        return _hui(t, col, sf, idx, 1, 7200)
    if col == "ss_addr_sk":
        return _hui(t, col, sf, idx, 1, c["customer_address"])
    if col == "ss_store_sk":
        return _hui(t, col, sf, idx, 1, c["store"])
    if col == "ss_promo_sk":
        return _hui(t, col, sf, idx, 1, c["promotion"])
    if col == "ss_ticket_number":
        return idx.astype(np.int64) // 4 + 1
    if col == "ss_quantity":
        return _hui(t, "ss_quantity", sf, idx, 1, 100)
    qty = _hui(t, "ss_quantity", sf, idx, 1, 100)
    wholesale = _hui(t, "ss_wholesale", sf, idx, 100, 8999)
    lp = wholesale * _hui(t, "ss_lp", sf, idx, 110, 219) // 100
    sp = lp * _hui(t, "ss_sp", sf, idx, 30, 100) // 100
    if col == "ss_wholesale_cost":
        return wholesale
    if col == "ss_list_price":
        return lp
    if col == "ss_sales_price":
        return sp
    if col == "ss_ext_discount_amt":
        return (lp - sp) * qty
    if col == "ss_ext_sales_price":
        return sp * qty
    if col == "ss_ext_wholesale_cost":
        return wholesale * qty
    if col == "ss_ext_list_price":
        return lp * qty
    if col == "ss_coupon_amt":
        disc = (lp - sp) * qty
        return np.where(_hu64(t, "ss_coupon", sf, idx)
                        % np.uint64(1000) < 200, disc // 2, 0)
    if col == "ss_net_paid":
        return sp * qty
    if col == "ss_ext_tax":
        return sp * qty * _hui(t, "ss_tax", sf, idx, 0, 11) // 100
    if col == "ss_net_paid_inc_tax":
        # locals qty/sp are already computed once per call — no recursion
        return sp * qty + sp * qty * _hui(t, "ss_tax", sf, idx,
                                          0, 11) // 100
    if col == "ss_net_profit":
        return (sp - wholesale) * qty
    raise KeyError(col)


def _catalogish_col(t, prefix, sf, col, idx, c, extra):
    """Shared column streams for catalog_sales/web_sales (identical spec
    shape modulo prefix and channel-specific FKs in `extra`)."""
    p = prefix
    if col == f"{p}_sold_date_sk":
        return _hui(t, col, sf, idx, _SALES_MIN, _SALES_MAX)
    if col == f"{p}_sold_time_sk":
        return _hui(t, col, sf, idx, 0, 86399)
    if col == f"{p}_ship_date_sk":
        return _hui(t, f"{p}_sold_date_sk", sf, idx, _SALES_MIN,
                    _SALES_MAX) + _hui(t, f"{p}_ship_delay", sf, idx, 2, 89)
    for role in ("bill", "ship"):
        if col == f"{p}_{role}_customer_sk":
            return _hui(t, col, sf, idx, 1, c["customer"])
        if col == f"{p}_{role}_cdemo_sk":
            return _hui(t, col, sf, idx, 1, c["customer_demographics"])
        if col == f"{p}_{role}_hdemo_sk":
            return _hui(t, col, sf, idx, 1, 7200)
        if col == f"{p}_{role}_addr_sk":
            return _hui(t, col, sf, idx, 1, c["customer_address"])
    if col == f"{p}_ship_mode_sk":
        return _hui(t, col, sf, idx, 1, 20)
    if col == f"{p}_warehouse_sk":
        return _hui(t, col, sf, idx, 1, c["warehouse"])
    if col == f"{p}_item_sk":
        return _hui(t, col, sf, idx, 1, c["item"])
    if col == f"{p}_promo_sk":
        return _hui(t, col, sf, idx, 1, c["promotion"])
    if col == f"{p}_order_number":
        return idx.astype(np.int64) // 3 + 1
    if col == f"{p}_quantity":
        return _hui(t, f"{p}_quantity", sf, idx, 1, 100)
    if col in extra:
        return extra[col](idx)
    qty = _hui(t, f"{p}_quantity", sf, idx, 1, 100)
    wholesale = _hui(t, f"{p}_wholesale", sf, idx, 100, 8999)
    lp = wholesale * _hui(t, f"{p}_lp", sf, idx, 110, 219) // 100
    sp = lp * _hui(t, f"{p}_sp", sf, idx, 30, 100) // 100
    tax = sp * qty * _hui(t, f"{p}_tax", sf, idx, 0, 11) // 100
    ship = sp * qty * _hui(t, f"{p}_shipc", sf, idx, 0, 9) // 100
    if col == f"{p}_wholesale_cost":
        return wholesale
    if col == f"{p}_list_price":
        return lp
    if col == f"{p}_sales_price":
        return sp
    if col == f"{p}_ext_discount_amt":
        return (lp - sp) * qty
    if col == f"{p}_ext_sales_price":
        return sp * qty
    if col == f"{p}_ext_wholesale_cost":
        return wholesale * qty
    if col == f"{p}_ext_list_price":
        return lp * qty
    if col == f"{p}_ext_tax":
        return tax
    if col == f"{p}_coupon_amt":
        disc = (lp - sp) * qty
        return np.where(_hu64(t, f"{p}_coupon", sf, idx)
                        % np.uint64(1000) < 200, disc // 2, 0)
    if col == f"{p}_ext_ship_cost":
        return ship
    if col == f"{p}_net_paid":
        return sp * qty
    if col == f"{p}_net_paid_inc_tax":
        return sp * qty + tax
    if col == f"{p}_net_paid_inc_ship":
        return sp * qty + ship
    if col == f"{p}_net_paid_inc_ship_tax":
        return sp * qty + ship + tax
    if col == f"{p}_net_profit":
        return (sp - wholesale) * qty
    raise KeyError(col)


def _cs_col(sf, col, idx, c):
    t = "catalog_sales"
    extra = {
        "cs_call_center_sk": lambda i: _hui(t, "cs_call_center_sk", sf, i,
                                            1, c["call_center"]),
        "cs_catalog_page_sk": lambda i: _hui(t, "cs_catalog_page_sk", sf, i,
                                             1, c["catalog_page"]),
    }
    return _catalogish_col(t, "cs", sf, col, idx, c, extra)


def _ws_col(sf, col, idx, c):
    t = "web_sales"
    extra = {
        "ws_web_page_sk": lambda i: _hui(t, "ws_web_page_sk", sf, i,
                                         1, c["web_page"]),
        "ws_web_site_sk": lambda i: _hui(t, "ws_web_site_sk", sf, i,
                                         1, c["web_site"]),
    }
    return _catalogish_col(t, "ws", sf, col, idx, c, extra)


def _returns_rowmap(table: str, sf: float, idx: np.ndarray) -> np.ndarray:
    """Return row j references sale row j*10 + jitter — a deterministic
    injective pick (stride 10 > jitter range), the seekable replacement
    for rng.choice(replace=False), so every return matches a real sale
    (q64's ss JOIN sr on ticket+item needs real pairs)."""
    jitter = (_hu64(table, "pick", sf, idx) % np.uint64(10)).astype(np.int64)
    return idx.astype(np.int64) * 10 + jitter


def _sr_col(sf, col, idx, c):
    t = "store_returns"
    r = _returns_rowmap(t, sf, idx).astype(np.uint64)
    if col == "sr_returned_date_sk":
        return _ss_col(sf, "ss_sold_date_sk", r, c) \
            + _hui(t, "sr_delay", sf, idx, 1, 59)
    if col == "sr_return_time_sk":
        return _hui(t, col, sf, idx, 28800, 75599)
    if col == "sr_reason_sk":
        return _hui(t, col, sf, idx, 1, c["reason"])
    if col == "sr_return_quantity":
        return _hui(t, col, sf, idx, 1, 49)

    def amount():
        # shared intermediate computed ONCE per (col, chunk) — see
        # _returnish_col's note on avoiding recursive re-derivation
        qty = _ss_col(sf, "ss_quantity", r, c)
        mult = 1 + (_hu64(t, "sr_amt", sf, idx)
                    % qty.astype(np.uint64)).astype(np.int64)
        return _ss_col(sf, "ss_sales_price", r, c) * mult

    def tax_of(amt):
        return amt * _hui(t, "sr_taxpct", sf, idx, 0, 11) // 100

    if col == "sr_return_amt":
        return amount()
    if col == "sr_return_tax":
        return tax_of(amount())
    if col == "sr_return_amt_inc_tax":
        amt = amount()
        return amt + tax_of(amt)
    if col == "sr_fee":
        return _hui(t, col, sf, idx, 50, 10000)
    if col == "sr_return_ship_cost":
        return _hui(t, col, sf, idx, 0, 10000)
    if col in ("sr_refunded_cash", "sr_reversed_charge",
               "sr_store_credit"):
        # three-way split of the returned amount
        amt = amount()
        cash = amt * _hui(t, "sr_cashpct", sf, idx, 0, 100) // 100
        rest = amt - cash
        charge = rest * _hui(t, "sr_chargepct", sf, idx, 0, 100) // 100
        if col == "sr_refunded_cash":
            return cash
        if col == "sr_reversed_charge":
            return charge
        return rest - charge
    if col == "sr_net_loss":
        return amount() // 2 + _hui(t, "sr_fee", sf, idx, 50, 10000)
    mapping = {"sr_item_sk": "ss_item_sk", "sr_customer_sk":
               "ss_customer_sk", "sr_cdemo_sk": "ss_cdemo_sk",
               "sr_hdemo_sk": "ss_hdemo_sk", "sr_addr_sk": "ss_addr_sk",
               "sr_store_sk": "ss_store_sk",
               "sr_ticket_number": "ss_ticket_number"}
    if col in mapping:
        return _ss_col(sf, mapping[col], r, c)
    raise KeyError(col)


def _returnish_col(t, p, sale_col, sp, sf, col, idx, c, extra):
    """Shared return streams for catalog_returns/web_returns: refunded_*
    mirror the sale's bill_* FKs (same buyer), returning_* are fresh
    draws (possibly a different account)."""
    r = _returns_rowmap(t, sf, idx).astype(np.uint64)
    if col == f"{p}_returned_date_sk":
        return sale_col(sf, f"{sp}_sold_date_sk", r, c) \
            + _hui(t, f"{p}_delay", sf, idx, 1, 59)
    if col == f"{p}_returned_time_sk":
        return _hui(t, col, sf, idx, 0, 86399)
    if col == f"{p}_reason_sk":
        return _hui(t, col, sf, idx, 1, c["reason"])
    if col == f"{p}_return_quantity":
        return _hui(t, col, sf, idx, 1, 49)
    amount_col = f"{p}_return_amount" if p == "cr" else f"{p}_return_amt"

    def amount():
        # shared intermediate computed ONCE per (col, chunk) — recursing
        # through _returnish_col re-derived the whole sale-price hash
        # chain per reference (2-3x waste on SF100 chunk scans)
        return sale_col(sf, f"{sp}_sales_price", r, c) \
            * _hui(t, f"{p}_amt", sf, idx, 1, 19)

    def tax_of(amt):
        return amt * _hui(t, f"{p}_taxpct", sf, idx, 0, 11) // 100

    if col == amount_col:
        return amount()
    if col == f"{p}_return_tax":
        return tax_of(amount())
    if col == f"{p}_return_amt_inc_tax":
        amt = amount()
        return amt + tax_of(amt)
    if col == f"{p}_fee":
        return _hui(t, col, sf, idx, 50, 10000)
    if col == f"{p}_return_ship_cost":
        return _hui(t, col, sf, idx, 0, 10000)
    credit_col = f"{p}_store_credit" if p == "cr" else f"{p}_account_credit"
    if col in (f"{p}_refunded_cash", f"{p}_reversed_charge", credit_col):
        amt = amount()
        cash = amt * _hui(t, f"{p}_cashpct", sf, idx, 0, 100) // 100
        rest = amt - cash
        charge = rest * _hui(t, f"{p}_chargepct", sf, idx, 0, 100) // 100
        if col == f"{p}_refunded_cash":
            return cash
        if col == f"{p}_reversed_charge":
            return charge
        return rest - charge
    if col == f"{p}_net_loss":
        return amount() // 2 + _hui(t, f"{p}_fee", sf, idx, 50, 10000)
    refunded = {
        f"{p}_refunded_customer_sk": f"{sp}_bill_customer_sk",
        f"{p}_refunded_cdemo_sk": f"{sp}_bill_cdemo_sk",
        f"{p}_refunded_hdemo_sk": f"{sp}_bill_hdemo_sk",
        f"{p}_refunded_addr_sk": f"{sp}_bill_addr_sk",
        f"{p}_item_sk": f"{sp}_item_sk",
        f"{p}_order_number": f"{sp}_order_number",
    }
    if col in refunded:
        return sale_col(sf, refunded[col], r, c)
    if col == f"{p}_returning_customer_sk":
        return _hui(t, col, sf, idx, 1, c["customer"])
    if col == f"{p}_returning_cdemo_sk":
        return _hui(t, col, sf, idx, 1, c["customer_demographics"])
    if col == f"{p}_returning_hdemo_sk":
        return _hui(t, col, sf, idx, 1, 7200)
    if col == f"{p}_returning_addr_sk":
        return _hui(t, col, sf, idx, 1, c["customer_address"])
    if col in extra:
        return extra[col](idx, r)
    raise KeyError(col)


def _cr_col(sf, col, idx, c):
    t = "catalog_returns"
    extra = {
        "cr_call_center_sk": lambda i, r: _cs_col(
            sf, "cs_call_center_sk", r, c),
        "cr_catalog_page_sk": lambda i, r: _cs_col(
            sf, "cs_catalog_page_sk", r, c),
        "cr_ship_mode_sk": lambda i, r: _cs_col(sf, "cs_ship_mode_sk",
                                                r, c),
        "cr_warehouse_sk": lambda i, r: _cs_col(sf, "cs_warehouse_sk",
                                                r, c),
    }
    return _returnish_col(t, "cr", _cs_col, "cs", sf, col, idx, c, extra)


def _wr_col(sf, col, idx, c):
    t = "web_returns"
    extra = {
        "wr_web_page_sk": lambda i, r: _ws_col(sf, "ws_web_page_sk", r, c),
    }
    return _returnish_col(t, "wr", _ws_col, "ws", sf, col, idx, c, extra)


def _inv_col(sf, col, idx, c):
    n_items = c["item"]
    n_wh = c["warehouse"]
    per_week = n_items * n_wh
    i = idx.astype(np.int64)
    if col == "inv_date_sk":
        return _SALES_MIN + 7 * (i // per_week)
    if col == "inv_warehouse_sk":
        return (i % per_week) // n_items + 1
    if col == "inv_item_sk":
        return i % n_items + 1
    if col == "inv_quantity_on_hand":
        return _hui("inventory", col, sf, idx, 0, 999)
    raise KeyError(col)


def _cd_col(sf, col, idx, c):
    seq = idx.astype(np.int64)
    if col == "cd_demo_sk":
        return seq + 1
    if col == "cd_purchase_estimate":
        return (seq // 70) % 20 * 500 + 500
    if col == "cd_dep_count":
        return (seq // 5600) % 7
    if col == "cd_dep_employed_count":
        return (seq // 39200) % 7
    if col == "cd_dep_college_count":
        return (seq // 274400) % 7
    raise KeyError(col)   # string columns handled via pools below


_CD_POOLS = {
    "cd_gender": (["M", "F"], lambda seq: seq % 2),
    "cd_marital_status": (["M", "S", "D", "W", "U"],
                          lambda seq: (seq // 2) % 5),
}


def chunk_numeric(table: str, sf: float, col: str, start: int,
                  end: int) -> np.ndarray:
    c = _row_counts(sf)
    idx = np.arange(start, end, dtype=np.uint64)
    fn = {"store_sales": _ss_col, "catalog_sales": _cs_col,
          "store_returns": _sr_col, "catalog_returns": _cr_col,
          "web_sales": _ws_col, "web_returns": _wr_col,
          "inventory": _inv_col, "customer_demographics": _cd_col}[table]
    out = fn(sf, col, idx, c)
    return np.asarray(out, dtype=np.int64)


def chunk_string(table: str, sf: float, col: str, start: int, end: int):
    """(codes int32, sorted pool) for a chunked table's pooled varchar."""
    seq = np.arange(start, end, dtype=np.int64)
    if table == "customer_demographics":
        if col in _CD_POOLS:
            pool, pick = _CD_POOLS[col]
        elif col == "cd_education_status":
            pool, pick = _EDUCATION, lambda s: (s // 10) % len(_EDUCATION)
        elif col == "cd_credit_rating":
            pool, pick = _CREDIT, lambda s: (s // 1400) % len(_CREDIT)
        else:
            raise KeyError(col)
        arr = np.asarray(pool, dtype=object)
        sorted_vals, inv = np.unique(arr, return_inverse=True)
        return inv.astype(np.int32)[pick(seq)], sorted_vals
    raise KeyError((table, col))


def _chunked_get_table(table: str, sf: float) -> Dict[str, np.ndarray]:
    """Materialize a chunked table fully (oracle loading at tiny SF)."""
    n = table_row_count(table, sf)
    out = {}
    for name, typ in TABLES[table][0]:
        if T.is_string(typ):
            codes, pool = chunk_string(table, sf, name, 0, n)
            out[name] = pool[codes]
        else:
            out[name] = chunk_numeric(table, sf, name, 0, n)
    return out


def get_table(table: str, sf: float) -> Dict[str, np.ndarray]:
    key = (table, round(sf * 1000))
    if key not in _TABLE_CACHE:
        if table in _CHUNKED:
            _TABLE_CACHE[key] = _chunked_get_table(table, sf)
        else:
            _TABLE_CACHE[key] = _gen_table(table, sf)
    return _TABLE_CACHE[key]


# FK suffix -> referenced dimension (a fact's *_sk columns draw from the
# dimension's key domain — claiming NDV = fact row count breaks join-order
# costing exactly like tpch's l_partkey did in round 4)
_SK_DOMAIN = {
    "item_sk": "item", "date_sk": "date_dim", "time_sk": "time_dim",
    "customer_sk": "customer", "cdemo_sk": "customer_demographics",
    "hdemo_sk": "household_demographics", "addr_sk": "customer_address",
    "store_sk": "store", "warehouse_sk": "warehouse",
    "promo_sk": "promotion", "income_band_sk": "income_band",
    "band_sk": "income_band", "call_center_sk": "call_center",
    "web_page_sk": "web_page", "catalog_page_sk": "catalog_page",
    "page_sk": "web_page",
    "web_site_sk": "web_site", "ship_mode_sk": "ship_mode",
    "reason_sk": "reason",
}


def _column_ndv(table: str, name: str, sf: float, rows: float) -> float:
    if name.endswith("_sk"):
        # own primary key -> row count; FK -> referenced dimension size
        for suffix, dim in _SK_DOMAIN.items():
            if name.endswith(suffix):
                if dim == table:
                    return rows
                try:
                    return float(table_row_count(dim, sf))
                except KeyError:
                    return rows
        return rows
    if name in ("d_year",):
        return 201.0
    if name in ("d_moy", "d_dom"):
        return 31.0
    if name == "d_week_seq":
        return float(_DATE_ROWS) / 7
    return float(min(rows, 1000.0))


def table_row_count(table: str, sf: float) -> int:
    counts = _row_counts(sf)
    if table == "inventory":
        weeks = len(np.arange(_SALES_MIN, _SALES_MAX, 7))
        return counts["item"] * counts["warehouse"] * weeks
    if table == "store_returns":
        return max(1, counts["store_sales"] // 10)
    if table == "catalog_returns":
        return max(1, counts["catalog_sales"] // 10)
    if table == "web_returns":
        return max(1, counts["web_sales"] // 10)
    return counts[table]


def table_dictionary(table: str, sf: float, column: str) -> Dictionary:
    key = (table, round(sf * 1000), column)
    if key not in _DICT_CACHE:
        if table in _CHUNKED:
            _, pool = chunk_string(table, sf, column, 0, 1)
            _DICT_CACHE[key] = Dictionary(pool)
        else:
            data = get_table(table, sf)[column]
            _DICT_CACHE[key] = Dictionary.build(data)[0]
    return _DICT_CACHE[key]


class TpcdsMetadata(ConnectorMetadata):
    """plugin/trino-tpcds TpcdsMetadata.java analog."""

    def list_schemas(self) -> List[str]:
        return sorted(SCHEMAS)

    def list_tables(self, schema: Optional[str] = None
                    ) -> List[SchemaTableName]:
        schemas = [schema] if schema else sorted(SCHEMAS)
        return [SchemaTableName(s, t) for s in schemas for t in sorted(TABLES)]

    def get_table_handle(self, name: SchemaTableName
                         ) -> Optional[ConnectorTableHandle]:
        if name.schema in SCHEMAS and name.table in TABLES:
            return ConnectorTableHandle(name)
        return None

    def get_table_metadata(self, handle: ConnectorTableHandle
                           ) -> TableMetadata:
        cols = tuple(ColumnMetadata(n, t)
                     for n, t in TABLES[handle.name.table][0])
        return TableMetadata(handle.name, cols)

    def get_table_statistics(self, handle: ConnectorTableHandle
                             ) -> TableStatistics:
        sf = SCHEMAS[handle.name.schema]
        rows = float(table_row_count(handle.name.table, sf))
        cols: Dict[str, ColumnStatistics] = {}
        for name, typ in TABLES[handle.name.table][0]:
            cols[name] = ColumnStatistics(
                null_fraction=0.0,
                distinct_count=_column_ndv(handle.name.table, name, sf,
                                           rows))
        return TableStatistics(rows, cols)

    def apply_filter(self, handle, constraint):
        merged = handle.constraint.intersect(constraint)
        return (ConnectorTableHandle(handle.name, merged, handle.limit),
                constraint)

    def apply_limit(self, handle, limit):
        if handle.limit is not None and handle.limit <= limit:
            return None
        return ConnectorTableHandle(handle.name, handle.constraint, limit)


class TpcdsSplitManager(ConnectorSplitManager):
    def get_splits(self, handle: ConnectorTableHandle,
                   target_splits: int = 1) -> List[Split]:
        sf = SCHEMAS[handle.name.schema]
        rows = table_row_count(handle.name.table, sf)
        parts = max(1, min(target_splits, math.ceil(rows / 4096)))
        return [Split(handle, p, parts, host=p) for p in range(parts)]


class TpcdsPageSource(ConnectorPageSource):
    def __init__(self, device):
        self.device = torch.device(device)

    def pages(self, split: Split, columns: Sequence[ColumnHandle],
              page_capacity: int) -> Iterator[Page]:
        handle = split.table
        table = handle.name.table
        sf = SCHEMAS[handle.name.schema]
        total = table_row_count(table, sf)
        start, end = split_range(total, split.part, split.total_parts)
        if handle.limit is not None:
            end = min(end, start + handle.limit)
        for off in range(start, end, page_capacity):
            hi = min(off + page_capacity, end)
            cols = [tpch.device_cached(
                ("tpcds", table, round(sf * 1000), ch.name, off, hi,
                 page_capacity), self.device,
                lambda ch=ch: _stage(table, sf, ch, off, hi, page_capacity,
                                     self.device))
                for ch in columns]
            yield Page(tuple(cols), row_count(hi - off, self.device))


def _stage(table: str, sf: float, ch: ColumnHandle, off: int, hi: int,
           page_capacity: int, device) -> Column:
    """One column slice generated on the host (cached in the host chunk
    LRU for the chunked tables), padded and staged to `device`."""
    d = table_dictionary(table, sf, ch.name) if T.is_string(ch.type) \
        else None
    if table in _CHUNKED:
        hkey = ("tpcds", table, round(sf * 1000), ch.name, off, hi)
        arr = tpch._host_cached(hkey, (
            lambda: chunk_string(table, sf, ch.name, off, hi)[0])
            if d is not None else (lambda: np.asarray(
                chunk_numeric(table, sf, ch.name, off, hi),
                T.to_numpy_dtype(ch.type))))
    else:
        # materialized tables: slicing is free — caching would duplicate
        # _TABLE_CACHE bytes in the LRU
        data = get_table(table, sf)[ch.name][off:hi]
        arr = d.encode(data) if d is not None else \
            np.asarray(data, T.to_numpy_dtype(ch.type))
    return Column.from_numpy(pad_to_capacity(arr, page_capacity, 0),
                             ch.type, dictionary=d, device=device)


def create_connector(device) -> Connector:
    """The TPC-DS connector staging its pages onto `device`."""
    return Connector("tpcds", TpcdsMetadata(), TpcdsSplitManager(),
                     TpcdsPageSource(device))
