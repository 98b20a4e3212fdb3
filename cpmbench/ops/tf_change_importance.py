"""The importance grid of a TF edit (after ``edit_tf``): only the cells
whose appearance the edit changed get importance. It hands the next steps
the grid (``ctx["grid"]``) and how the reference makes it again
(``ctx["grid_ref"]``, a function of the checker)."""


def program(side, scene, prev_scene):
    return side.step.build_tf_change_importance_grid(
        scene, side.config, prev_scene.tf.positions, prev_scene.tf.colors)


def reference(side, scene, prev_scene):
    return side.P.build_tf_change_importance_grid(
        scene, side.config, prev_scene.tf.positions, prev_scene.tf.colors)


def run(s, step, ctx, record):
    ctx["grid"] = s.on(program, reference)(s.scene, ctx["prev_scene"])
    before, after = ctx["tf_before"], (s.tf_pos, s.tf_col)

    def grid_ref(c):
        return reference(c.ref, c.scene(tf=after), c.scene(tf=before))
    ctx["grid_ref"] = grid_ref
