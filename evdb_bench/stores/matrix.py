"""Store builder ``matrix``: one ``VectorStore`` of the configuration's
dtype and metric made from the drawn corpus on the card
(``VectorStore.from_matrix``) and adopted by the Application's registry, as
a store loaded at start-up would be; warmed at the traffic's batch sizes.

A store builder gives ``build(app, config, data, device)`` and
``warm(store, config, traffic)``; the built object answers ``count``."""

from __future__ import annotations


def build(app, config: dict, data, device):
    from erlvectordb_tpu_torch.core.store import VectorStore

    st = config["store"]
    store = VectorStore.from_matrix(
        config["name"], data, metric=config["metric"], dtype=st["dtype"],
        intkey=bool(st.get("intkey", False)), device=device)
    app.db.registry.adopt(store)
    return store


def warm(store, config: dict, traffic: dict) -> None:
    store.warmup(batch_sizes=tuple(traffic["warm_batches"]),
                 ks=(config["k"],))
