"""The data plane's wire format (``serializer``).

Counterpart of the serializer of ``distar_tpu.comm``; the shared-memory
rings (``shm_ring``) come with ROADMAP Queue 1 item 2, and the rest of
``comm`` with item 5.
"""
