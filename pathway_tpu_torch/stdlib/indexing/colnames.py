"""Shared column-name constants of the index layer.

Reference parity: python/pathway/stdlib/indexing/colnames.py.
"""

_INDEX_REPLY = "_pw_index_reply"
_INDEX_REPLY_ID = "_pw_index_reply_id"
_INDEX_REPLY_SCORE = "_pw_index_reply_score"
_QUERY_ID = "_pw_query_id"
_MATCHED_ID = "_pw_matched_id"
_SCORE = "_pw_dist"
