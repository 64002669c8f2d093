"""Replay: the consistent-hash ring only (``sharding``), which the serving
fleet's router pins sessions with. The replay store, its server and
clients, and the sharded fleet come with ROADMAP Queue 1 item 5."""
