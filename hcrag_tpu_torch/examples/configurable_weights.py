"""Configurable-weights demo: the reference's EXAMPLE_configurable_weights.py.

Counterpart of `examples/configurable_weights.py`.  Shows every way to
configure the relevance scorer: defaults, presets, from_dict, custom
instances, and the global-config setters, scored over the 18 fixture nodes
by `batch_isRelevant` on the card unless `--device` names another device.

Run: python -m hcrag_tpu_torch.examples.configurable_weights [--device cpu]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without CUDA it raises)")
    args = ap.parse_args(argv)

    from hcrag_tpu_torch.config import reset_global_config, set_composite_weights
    from hcrag_tpu_torch.core.types import CompositeWeights, ScorerType
    from hcrag_tpu_torch.pipeline.isrelevant import batch_isRelevant
    from hcrag_tpu_torch.testing import create_sample_nodes, create_sample_query

    query = create_sample_query()
    nodes = create_sample_nodes()

    configs = {
        "default (.30/.45/.15/.10)": CompositeWeights(),
        "balanced": CompositeWeights.create_balanced(),
        "semantic_focused": CompositeWeights.create_semantic_focused(),
        "llm_focused": CompositeWeights.create_llm_focused(),
        "entity_focused": CompositeWeights.create_entity_focused(),
        "from_dict": CompositeWeights.from_dict(
            {"semantic_similarity": 0.5, "llm_judge": 0.2,
             "entity_match": 0.2, "node_type_priority": 0.1}
        ),
    }

    print(f"Query: {query.text}\n")
    for name, weights in configs.items():
        scores = batch_isRelevant(
            query, nodes, ScorerType.COMPOSITE, weights=weights, device=args.device
        )
        ranked = sorted(zip(scores, nodes), key=lambda x: -x[0])[:3]
        print(f"== {name} ==")
        for s, n in ranked:
            print(f"  {s:.3f}  {n.text[:64]}")
        print()

    # Global configuration (the reference's setter API).
    set_composite_weights(CompositeWeights.create_entity_focused())
    print("global weights set to entity_focused; resetting...")
    reset_global_config()

    # Validation errors surface immediately:
    try:
        CompositeWeights(0.9, 0.9, 0.1, 0.1)
    except ValueError as e:
        print(f"validation works: {e}")


if __name__ == "__main__":
    main()
